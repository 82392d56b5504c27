"""Vision transforms of the PyTorch port (≙ python/mxnet/gluon/data/vision/
transforms.py; the counterpart of the JAX package's
`gluon/data/vision/transforms.py`).

Transforms take HWC uint8/float images (or NHWC batches), the reference
convention, as NDArrays or tensors, on whatever device they lie (the
DataLoader's workers build host batches). ToTensor converts HWC [0,255] →
CHW [0,1] float32 like the reference. The random transforms draw from
numpy's global generator, as the JAX package's do, so one `np.random.seed`
gives both packages the same crops and flips. Resize is the JAX package's
`jax.image.resize(..., "linear")`: a triangle kernel, widened by the
downscale factor (antialiasing), weights normalized per output pixel.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ....base import to_torch_dtype
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "CropResize"]


class Compose(Sequential):
    """≙ transforms.Compose."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.to(to_torch_dtype(self._dtype))


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (≙ transforms.ToTensor)."""

    def forward(self, x):
        x = x.to(torch.float32) / 255.0
        if x.dim() == 3:
            return x.permute(2, 0, 1)
        return x.permute(0, 3, 1, 2)


class Normalize(HybridBlock):
    """(x - mean) / std per channel on CHW input (≙ transforms.Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, _np.float32).reshape(-1, 1, 1)
        self._std = _np.asarray(std, _np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        mean = torch.from_numpy(self._mean).to(x.device)
        std = torch.from_numpy(self._std).to(x.device)
        return (x - mean) / std


def _resize_weights(m, n, device):
    """jax.image's (m, n) weight matrix of a linear resize from m to n
    samples (`compute_weight_mat` with the triangle kernel, antialiased),
    in float32 op by op."""
    f32 = torch.float32
    inv_scale = 1.0 / (n / m)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32)
    sample_f = (torch.arange(n, dtype=f32) + 0.5) * torch.tensor(
        inv_scale, dtype=f32) - 0.0 - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(_np.finfo(_np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize_hwc(x, size, interp="bilinear"):
    """Resize an HWC image or NHWC batch to `size` ((w, h), reference
    order; an int is square), as float32."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    x = x.to(torch.float32)
    hd, wd = x.dim() - 3, x.dim() - 2
    if x.shape[hd] != h:
        x = torch.movedim(torch.tensordot(
            x, _resize_weights(x.shape[hd], h, x.device), dims=([hd], [0])),
            -1, hd)
    if x.shape[wd] != w:
        x = torch.movedim(torch.tensordot(
            x, _resize_weights(x.shape[wd], w, x.device), dims=([wd], [0])),
            -1, wd)
    return x


class Resize(Block):
    """≙ transforms.Resize(size, keep_ratio, interpolation)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interp = "bilinear"

    def forward(self, x):
        size = self._size
        if self._keep and isinstance(size, int):
            h, w = x.shape[-3], x.shape[-2]
            if h < w:
                size = (int(w * size / h), size)
            else:
                size = (size, int(h * size / w))
        return _resize_hwc(x, size, self._interp)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        out = x[..., y0:y0 + h, x0:x0 + w, :]
        if out.shape[-3] != h or out.shape[-2] != w:
            out = _resize_hwc(out, (w, h))
        return out


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        w, h = self._size
        if self._pad:
            p = self._pad
            x = F.pad(x, (0, 0, p, p, p, p))
        H, W = x.shape[-3], x.shape[-2]
        y0 = _np.random.randint(0, max(H - h, 0) + 1)
        x0 = _np.random.randint(0, max(W - w, 0) + 1)
        return x[..., y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    """≙ transforms.RandomResizedCrop (area/ratio jitter then resize)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[-3], x.shape[-2]
        area = H * W
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            log_ratio = (_np.log(self._ratio[0]), _np.log(self._ratio[1]))
            aspect = _np.exp(_np.random.uniform(*log_ratio))
            w = int(round(_np.sqrt(target_area * aspect)))
            h = int(round(_np.sqrt(target_area / aspect)))
            if 0 < w <= W and 0 < h <= H:
                y0 = _np.random.randint(0, H - h + 1)
                x0 = _np.random.randint(0, W - w + 1)
                crop = x[..., y0:y0 + h, x0:x0 + w, :]
                return _resize_hwc(crop, self._size)
        return _resize_hwc(x, self._size)  # fallback


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _np.random.rand() < self._p:
            return torch.flip(x, dims=(x.dim() - 2,))
        return x


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _np.random.rand() < self._p:
            return torch.flip(x, dims=(x.dim() - 3,))
        return x


class CropResize(Block):
    """≙ transforms.CropResize(x, y, w, h, size)."""

    def __init__(self, x, y, width, height, size=None, interpolation=None):
        super().__init__()
        self._x, self._y = x, y
        self._w, self._h = width, height
        self._size = size

    def forward(self, img):
        out = img[..., self._y:self._y + self._h,
                  self._x:self._x + self._w, :]
        if self._size:
            out = _resize_hwc(out, self._size)
        return out
