"""Out-of-process image-record decode worker (shared-memory handoff).

Launched by `io.imagerec_pool.DecodePool` as a BARE subprocess — run by
file path, never imported through the package, so a worker costs one
python+numpy start instead of a torch import, never initializes CUDA
(it imports no torch; the pool also starts it with CUDA_VISIBLE_DEVICES
empty), and the decode loop never contends with the trainer's GIL
(≙ one decode thread of the reference's `iter_image_recordio_2.cc` pool,
moved to a process so the PIL/pure-Python fallback scales across cores
too). The PyTorch port's copy of the JAX package's worker.

Protocol (line-delimited JSON, one reply per command):

  stdin line 0:  the config object (shm name + slot layout + decode spec)
  stdout line 0: {"ready": true, "backend": "native"|"python"}
  stdin:   {"op": "decode", "batch": B, "slot": S, "start": i,
            "count": k, "seed": n}
  stdout:  {"batch": B, "slot": S, "start": i, "failed": f}
           (or {..., "error": "repr"} — the pool resurfaces it)
  stdin:   {"op": "quit"}  (or EOF)  -> exit 0

Record indices travel through the slot's int64 shm region (written by the
pool before the command is sent), decoded pixels land directly in the
slot's image region rows [start, start+count) — no pickling, no pipe
bytes beyond the ~100-byte command. Every record's augment RNG is seeded
by (seed, record index) alone (`_imagerec_common.record_seed`), so any
shard split across any number of workers reproduces the identical batch.
"""
import json
import os
import sys
import time


def _load_standalone(name, path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[name] = mod
    return mod


def main():
    cfg = json.loads(sys.stdin.readline())
    import numpy as np
    from multiprocessing import shared_memory

    here = os.path.dirname(os.path.abspath(__file__))
    common = _load_standalone("_mxtpu_imagerec_common",
                              os.path.join(here, "_imagerec_common.py"))

    h, w = int(cfg["h"]), int(cfg["w"])
    label_width = int(cfg["label_width"])
    cap = int(cfg["slot_capacity"])
    n_slots = int(cfg["n_slots"])
    out_u8 = cfg["out"] == "u8"
    resize = int(cfg["resize"])
    rand_crop = bool(cfg["rand_crop"])
    rand_mirror = bool(cfg["rand_mirror"])
    mean = cfg.get("mean")
    std = cfg.get("std")
    itemsize = 1 if out_u8 else 4
    img_dtype = np.uint8 if out_u8 else np.float32

    shm = shared_memory.SharedMemory(name=cfg["shm_name"])
    try:
        # attaching registers the segment with THIS process's resource
        # tracker (CPython < 3.13 has no track=False), which would try to
        # unlink the pool's shm at worker exit — the pool owns the lifetime
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    img_bytes = cap * h * w * 3 * itemsize
    lab_bytes = cap * label_width * 4
    idx_bytes = cap * 8
    slot_bytes = img_bytes + lab_bytes + idx_bytes
    slots = []
    for s in range(n_slots):
        base = s * slot_bytes
        images = np.ndarray((cap, h, w, 3), img_dtype, shm.buf,
                            offset=base)
        labels = np.ndarray((cap, label_width), np.float32, shm.buf,
                            offset=base + img_bytes)
        indices = np.ndarray((cap,), np.int64, shm.buf,
                             offset=base + img_bytes + lab_bytes)
        slots.append((images, labels, indices))

    # decode backend: the native library standalone (no package import),
    # else the shared pure-Python pipeline (PIL; geometry-parity with
    # native via the common augment spec)
    native = None
    pyidx = None
    try:
        nat = _load_standalone("_mxtpu_native_standalone",
                               os.path.join(cfg["native_dir"],
                                            "__init__.py"))
        native = nat.NativeImageRecordFile(
            cfg["rec_path"], num_threads=int(cfg.get("native_threads", 1)))
    except Exception:
        native = None
    if native is None:
        pyidx = common.PyRecordIndex(cfg["rec_path"])

    def reply(obj):
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    reply({"ready": True,
           "backend": "native" if native is not None else "python",
           "pid": os.getpid()})

    # test hook: die (hard, mid-batch, before replying) on the Nth decode
    # command — the deterministic worker-death point the restart-budget
    # tests use (non-MXNET name: internal, never a user knob)
    die_before = int(os.environ.get("MXTPU_TEST_WORKER_DIE_BEFORE", "0"))
    n_decodes = 0

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        cmd = json.loads(line)
        if cmd.get("op") == "quit":
            break
        if cmd.get("op") != "decode":
            reply({"error": f"unknown op {cmd.get('op')!r}"})
            continue
        n_decodes += 1
        if die_before and n_decodes >= die_before:
            print("test hook: dying before decode reply", file=sys.stderr)
            sys.stderr.flush()
            os._exit(3)
        b, s = cmd["batch"], cmd["slot"]
        start, count, seed = cmd["start"], cmd["count"], cmd["seed"]
        images, labels, indices = slots[s]
        out = {"batch": b, "slot": s, "start": start}
        t0 = time.perf_counter_ns()
        try:
            idx = indices[start:start + count]
            if native is not None:
                shard_img = images[start:start + count]
                shard_lab = labels[start:start + count]
                if out_u8:
                    _, _, failed = native.read_batch_u8(
                        idx, (h, w, 3), resize=resize, rand_crop=rand_crop,
                        rand_mirror=rand_mirror, seed=seed,
                        label_width=label_width, out_images=shard_img,
                        out_labels=shard_lab)
                else:
                    _, _, failed = native.read_batch(
                        idx, (h, w, 3), resize=resize, rand_crop=rand_crop,
                        rand_mirror=rand_mirror, seed=seed, mean=mean,
                        std=std, label_width=label_width,
                        out_images=shard_img, out_labels=shard_lab)
            else:
                failed = 0
                for k, i in enumerate(idx):
                    row = start + k
                    try:
                        img, lab = common.process_record(
                            pyidx.payload(int(i)), h, w, resize, rand_crop,
                            rand_mirror, common.record_seed(seed, int(i)),
                            label_width, out_u8, mean=mean, std=std)
                        images[row] = img
                        labels[row] = lab
                    except ValueError:
                        # per-record corruption: zero-fill, native parity.
                        # ImportError (no PIL at all) deliberately escapes
                        # to the command-level error reply — an environment
                        # problem must fail the batch loudly, not train on
                        # silently zero-filled data
                        images[row] = 0
                        labels[row] = -1.0
                        failed += 1
            out["failed"] = int(failed)
            if native is not None:
                # per-stage clock delta since the last reply: the pool
                # aggregates these into io_stats(), so stage attribution
                # survives the process boundary
                out["stages"] = nat.imagerec_stage_stats(reset=True)
            else:
                # PIL path: no native clocks — the whole shard's wall
                # time IS the decode stage, so attribution (and the
                # worker trace lane) still survives the boundary
                out["stages"] = {
                    "decode_ns": time.perf_counter_ns() - t0,
                    "decoded_records": int(count)}
        except BaseException as e:
            out["error"] = f"{type(e).__name__}: {e}"
        # shard wall time: the parent renders it as this worker's lane in
        # the consuming iterator's Chrome trace
        out["dur_ns"] = time.perf_counter_ns() - t0
        reply(out)

    shm.close()


if __name__ == "__main__":
    main()
