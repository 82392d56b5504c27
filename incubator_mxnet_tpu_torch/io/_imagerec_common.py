"""Shared image-record augment spec + pure-Python decode pipeline.

ONE home for the per-record geometry contract of the image pipeline —
the splitmix64 RNG stream, crop-offset/mirror consumption order, DCT
scaling denominator and shorter-side resize dims — replicated bit-for-bit
from `native/imagerec.cc` (`Rng`, `ProcessOne`, `DecodeJpeg`). The PIL
fallback and the out-of-process shm workers both decode through here, so
crop/flip decisions agree with the native path record-by-record instead
of drifting per backend.

IMPORT CONTRACT: stdlib + numpy only, no package-relative imports — the
shm worker (`io/_shm_worker.py`) loads this module standalone by file
path from a bare subprocess that must never import torch (nor touch a
CUDA context). The PyTorch port's copy of the JAX package's module: the
augment spec is the same code, so both packages decode a record alike.
"""
from __future__ import annotations

import struct

import numpy as np

MASK64 = (1 << 64) - 1
_GOLDEN = 0x9e3779b97f4a7c15

IRHEADER_BYTES = 24  # <IfQQ: flag u32, label f32, id u64, id2 u64


class Rng:
    """splitmix64 — mirrors `Rng` in imagerec.cc (same constants, same
    `below` via modulo, so consumption order == crop/mirror parity)."""

    __slots__ = ("s",)

    def __init__(self, seed):
        self.s = seed & MASK64

    def next(self):
        self.s = (self.s + _GOLDEN) & MASK64
        z = self.s
        z = ((z ^ (z >> 30)) * 0xbf58476d1ce4e5b9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94d049bb133111eb) & MASK64
        return (z ^ (z >> 31)) & MASK64

    def below(self, n):
        return self.next() % n if n else 0


def record_seed(seed, idx):
    """Per-record deterministic seed — `seed ^ (golden * (idx+1))` like
    ir_read_batch, so any worker sharding reproduces the same stream."""
    return (seed ^ ((_GOLDEN * (idx + 1)) & MASK64)) & MASK64


def dct_denom(w, h, min_target):
    """libjpeg DCT-domain scaling denominator the native decoder picks:
    largest power of two (<=8) whose scaled shorter side still covers
    `min_target` (0 disables)."""
    if min_target <= 0:
        return 1
    full_min = min(w, h)
    denom = 1
    while denom < 8 and full_min // (denom * 2) >= min_target:
        denom *= 2
    return denom


def resized_dims(w, h, short_target, out_w, out_h):
    """Virtual shorter-side resize dims (nw, nh) for decoded size (w, h),
    clamped so the crop always fits — matches ProcessOne."""
    scale = float(short_target) / min(w, h)
    nw = int(w * scale + 0.5)
    nh = int(h * scale + 0.5)
    return max(nw, out_w), max(nh, out_h)


def crop_spec(rec_seed, nw, nh, out_w, out_h, rand_crop, rand_mirror):
    """(x0, y0, mirror) for one record — EXACT native consumption order:
    `below(max_x+1)` then `below(max_y+1)` (only when rand_crop; center
    crop consumes nothing), then one `next()` for the mirror coin (only
    when rand_mirror)."""
    rng = Rng(rec_seed)
    max_x, max_y = nw - out_w, nh - out_h
    if rand_crop:
        x0 = rng.below(max_x + 1)
        y0 = rng.below(max_y + 1)
    else:
        x0, y0 = max_x // 2, max_y // 2
    mirror = bool(rand_mirror and (rng.next() & 1))
    return x0, y0, mirror


def short_target(resize, out_w, out_h):
    """Shorter-side target before crop (resize>0) — else the crop's longer
    side, like ProcessOne."""
    return resize if resize > 0 else max(out_w, out_h)


def parse_record(payload, label_width):
    """(labels float32[label_width], image_bytes) from an IRHeader-packed
    record — same flag/extra-label layout ProcessOne reads. Returns
    (None, None) for truncated records."""
    if len(payload) < IRHEADER_BYTES:
        return None, None
    flag, label0 = struct.unpack_from("<If", payload, 0)
    labels = np.zeros((label_width,), np.float32)
    off = IRHEADER_BYTES
    if flag > 0:
        extra = 4 * flag
        if len(payload) < IRHEADER_BYTES + extra:
            return None, None
        m = min(label_width, flag)
        labels[:m] = np.frombuffer(payload, "<f4", count=m,
                                   offset=IRHEADER_BYTES)
        off += extra
    else:
        labels[0] = label0
    return labels, payload[off:]


def decode_image(img_bytes, min_target):
    """Decode to HxWx3 uint8 RGB. PIL when available — with the same
    JPEG DCT `draft` scaling denominator the native decoder uses, so the
    decoded dims (and therefore every crop offset downstream) match the
    native path. Raises ValueError on corrupt input, ImportError without
    PIL."""
    import io as _pyio

    from PIL import Image
    try:
        img = Image.open(_pyio.BytesIO(img_bytes))
        if img.format == "JPEG" and min_target > 0:
            denom = dct_denom(*img.size, min_target)
            if denom > 1:
                img.draft(None, (img.size[0] // denom,
                                 img.size[1] // denom))
        img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.uint8)
    except Exception as e:
        raise ValueError(f"image decode failed: {e}") from e
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"decoded shape {arr.shape} is not HxWx3")
    return arr


def sample_bilinear(img, nw, nh, x0, y0, out_h, out_w, mirror):
    """Vectorized port of imagerec.cc SamplePass: virtual shorter-side
    resize + crop + mirror through ONE separable-bilinear map (half-pixel
    convention at both hops), float32 result in [0, 255]."""
    h, w = img.shape[:2]
    fx = np.clip((x0 + np.arange(out_w) + 0.5) * (w / nw) - 0.5, 0, w - 1)
    fy = np.clip((y0 + np.arange(out_h) + 0.5) * (h / nh) - 0.5, 0, h - 1)
    ix0 = fx.astype(np.int64)
    iy0 = fy.astype(np.int64)
    ix1 = np.minimum(ix0 + 1, w - 1)
    iy1 = np.minimum(iy0 + 1, h - 1)
    wx = (fx - ix0).astype(np.float32)[None, :, None]
    wy = (fy - iy0).astype(np.float32)[:, None, None]
    imgf = img.astype(np.float32)
    top = imgf[iy0][:, ix0] * (1 - wx) + imgf[iy0][:, ix1] * wx
    bot = imgf[iy1][:, ix0] * (1 - wx) + imgf[iy1][:, ix1] * wx
    out = top * (1 - wy) + bot * wy
    if mirror:
        out = out[:, ::-1]
    return out


def process_record(payload, out_h, out_w, resize, rand_crop, rand_mirror,
                   rec_seed, label_width, out_u8, mean=None, std=None):
    """Full per-record Python pipeline (decode -> resize -> crop ->
    mirror -> [normalize]) mirroring ProcessOne. Returns (image, labels)
    with image uint8 raw pixels (out_u8) or normalized float32; raises
    ValueError/ImportError on undecodable input (caller zero-fills)."""
    labels, img_bytes = parse_record(payload, label_width)
    if labels is None:
        raise ValueError("truncated record")
    st = short_target(resize, out_w, out_h)
    img = decode_image(img_bytes, st)
    nw, nh = resized_dims(img.shape[1], img.shape[0], st, out_w, out_h)
    x0, y0, mirror = crop_spec(rec_seed, nw, nh, out_w, out_h,
                               rand_crop, rand_mirror)
    out = sample_bilinear(img, nw, nh, x0, y0, out_h, out_w, mirror)
    if out_u8:
        return (out + 0.5).astype(np.uint8), labels
    out = out * np.float32(1.0 / 255.0)
    if mean is not None:
        out = out - np.asarray(mean, np.float32)
    if std is not None:
        out = out / np.asarray(std, np.float32)
    return out.astype(np.float32), labels


# ---------------------------------------------------------------------------
# pure-python .rec access (the worker's no-toolchain fallback; mirrors
# recordio_core.h BuildIndex/CopyRecord framing)
# ---------------------------------------------------------------------------
_REC_MAGIC = 0x3ed7230a
_LFLAG_BITS = 29
_LMASK = (1 << _LFLAG_BITS) - 1


class PyRecordIndex:
    """Random-access .rec reader without the native library: scans the
    magic/length framing once, reassembles chunked payloads on read."""

    def __init__(self, path):
        import mmap
        with open(path, "rb") as f:
            try:
                # shared page cache, not a private copy: N shm workers on
                # one .rec must not cost N x file-size of RSS
                self._data = mmap.mmap(f.fileno(), 0,
                                       access=mmap.ACCESS_READ)
            except (ValueError, OSError):    # zero-byte / exotic fs
                self._data = f.read()
        data = self._data
        self._recs = []  # (offset, chunked)
        pos, size = 0, len(data)
        while pos + 8 <= size:
            if struct.unpack_from("<I", data, pos)[0] != _REC_MAGIC:
                raise ValueError(f"bad magic at offset {pos}")
            start = pos
            chunked = False
            while True:
                if pos + 8 > size:
                    raise ValueError("truncated record header")
                lrec = struct.unpack_from("<I", data, pos + 4)[0]
                cflag, ln = lrec >> _LFLAG_BITS, lrec & _LMASK
                pos += 8 + ((ln + 3) & ~3)
                if pos > size:
                    raise ValueError("truncated record payload")
                if cflag == 0:
                    break
                chunked = True
                if cflag == 3:
                    break
            self._recs.append((start, chunked))

    def __len__(self):
        return len(self._recs)

    def payload(self, idx):
        data = self._data
        pos, chunked = self._recs[idx]
        parts = []
        first = True
        while True:
            lrec = struct.unpack_from("<I", data, pos + 4)[0]
            cflag, ln = lrec >> _LFLAG_BITS, lrec & _LMASK
            if not first:
                parts.append(struct.pack("<I", _REC_MAGIC))
            parts.append(data[pos + 8:pos + 8 + ln])
            pos += 8 + ((ln + 3) & ~3)
            if cflag in (0, 3):
                break
            first = False
        return b"".join(parts)
