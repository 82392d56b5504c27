#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`incubator_mxnet_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Run from the repository root, on a machine with one CUDA card and `nvcc`.
Each phase fails the run (non-zero exit) on any error:

  1. setup: the card's name and power limit; every CUDA kernel of the
     port is built from `incubator_mxnet_tpu_torch/ops/csrc` (timed).
  2. kernels against their plain versions on the card: paged attention
     at the serving shapes (16 lanes, 12 heads x 64, 2048 positions,
     12 layers), float32 and bfloat16, one query (decode) and 256 queries
     (chunk prefill), ragged lengths, and a slab view cut on the position
     axis; then the kernel's time against its bound, the plain version's
     time and one PyTorch library call's time.
  3. serving at full width: `ContinuousEngine` over a 12-layer, 768-wide
     `CachedDecoder` (vocab 32000, 2048 positions, random weights from a
     seed) answers 16 greedy requests with prompts of 16-1500 tokens, in
     bfloat16 (timed; the kernel's launch counter must move by exactly
     layers x (decode_steps x decode waves + chunk waves)) and in float32
     with TF32 off, where every request's tokens must equal the 1-slot
     `reference_generate`.

The last three lines are the card's name and power limit, one JSON object
with the kernels' numbers, and `{"ok": true, "device": {...}}`. Without a
card the script exits non-zero and prints no result. It imports nothing of
JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from incubator_mxnet_tpu_torch import serve
from incubator_mxnet_tpu_torch.ops import fused, kernels

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12,         # f32 outside the tensor cores
            torch.bfloat16: 989e12}       # dense bf16 tensor cores
TOL = {torch.float32: 1e-4,               # f32 sums in another order
       torch.bfloat16: 2e-2}              # bf16 output rounding dominates
FULL = dict(vocab=32000, embed=768, layers=12, heads=12, head_dim=64,
            mlp_hidden=3072, max_len=2048)
SLOTS, WINDOW, DECODE_STEPS, NEW_TOKENS = 16, 256, 4, 64


def log(*a):
    print(*a, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, reps, warmup=2):
    """Median of `reps` CUDA-event timings of fn(i) (i = repetition)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    evs = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


# ---------------------------------------------------------------------------
# phase 2: paged attention against its plain version
# ---------------------------------------------------------------------------
def attention_bound(lens, C, T, H, D, dtype):
    """Least time (ms) for the work: bytes moved (q read, out written,
    lengths read, each lane's live K/V read once) over the memory rate,
    against the multiply-adds this data needs over the peak for the type."""
    item = torch.empty((), dtype=dtype).element_size()
    S = len(lens)
    live = sum(min(T, int(n) + C) for n in lens)
    nbytes = 2 * S * C * H * D * item + 4 * S + live * H * D * 2 * item
    # query j of lane s attends over min(T, len + j + 1) positions, and
    # each position costs 2 * D multiply-adds (q.k and p.v), 2 ops each
    ops = sum(min(T, int(n) + j + 1) for n in lens for j in range(C)) \
        * H * D * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_call(q, k_slab, v_slab, lens, layer):
    """One scaled_dot_product_attention call over each lane's gathered
    live prefix with the same mask (the yardstick; the port never calls
    it). Returns (fn, reference output)."""
    S, C, H, D = q.shape
    tmax = min(k_slab.shape[2], int(lens.max()) + C)
    kk = k_slab[:S, layer, :tmax].transpose(1, 2).contiguous()
    vv = v_slab[:S, layer, :tmax].transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()
    pos = torch.arange(tmax, device=q.device)
    lim = lens.long()[:, None] + torch.arange(C, device=q.device)[None]
    mask = (pos[None, None, :] <= lim[:, :, None])[:, None]   # (S,1,C,T)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fn(_i):
        return sdpa(qq, kk, vv, attn_mask=mask)
    return fn, fn(0).transpose(1, 2)


def phase_kernels(dev):
    S, H, D, T, L = SLOTS, FULL["heads"], FULL["head_dim"], \
        FULL["max_len"], FULL["layers"]
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (S + 1, L, T, H, D)
    k32 = torch.randn(shape, generator=gen, device=dev)
    v32 = torch.randn(shape, generator=gen, device=dev)
    rng = np.random.RandomState(0)
    lens_np = np.concatenate([[0, 1, 255, 1000, 2047],
                              rng.randint(0, T, S - 5)]).astype(np.int32)
    lens = torch.as_tensor(lens_np, device=dev)
    layer = 5
    variants = []
    for dtype in (torch.float32, torch.bfloat16):
        k_slab, v_slab = k32.to(dtype), v32.to(dtype)
        for C in (1, WINDOW):
            q = torch.randn((S, C, H, D), generator=gen, device=dev).to(dtype)
            out = kernels.paged_attention_cuda(q, k_slab, v_slab, lens, layer)
            ref = fused.paged_attention_ref(q, k_slab, v_slab, lens, layer)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            # a view cut on the position axis, lengths inside the cut:
            # against the plain version on the view, and bit-equal to the
            # full-slab read (the engine's extent ladder relies on it)
            ext = 1280
            lens_e = torch.clamp(lens, max=ext - C)
            out_v = kernels.paged_attention_cuda(
                q, k_slab[:, :, :ext], v_slab[:, :, :ext], lens_e, layer)
            ref_v = fused.paged_attention_ref(
                q, k_slab[:, :, :ext], v_slab[:, :, :ext], lens_e, layer)
            out_f = kernels.paged_attention_cuda(q, k_slab, v_slab, lens_e,
                                                 layer)
            torch.cuda.synchronize()
            err_v = (out_v.float() - ref_v.float()).abs().max().item()
            same = torch.equal(out_v, out_f)
            assert torch.isfinite(out.float()).all(), "non-finite output"
            name = f"{str(dtype).split('.')[-1]} C={C}"
            log(f"[kernels] paged_attention {name}: max_abs_err {err:.3e} "
                f"(view {err_v:.3e}, view == full: {same}) tol "
                f"{TOL[dtype]:.0e}")
            assert err <= TOL[dtype] and err_v <= TOL[dtype], \
                f"paged_attention {name} disagrees with its plain version"
            assert same, f"paged_attention {name}: extent view != full read"
            # timing: rotate over the 12 layers so the live prefix comes
            # from device memory, as in the engine's layer loop
            ms = median_ms(lambda i: kernels.paged_attention_cuda(
                q, k_slab, v_slab, lens, i % L), reps=24)
            plain_ms = median_ms(lambda i: fused.paged_attention_ref(
                q, k_slab, v_slab, lens, i % L), reps=5, warmup=1)
            lib_fn, lib_out = library_call(q, k_slab, v_slab, lens, layer)
            lib_err = (lib_out.float() - ref.float()).abs().max().item()
            lib_ms = median_ms(lib_fn, reps=24)
            bound_ms, bound_by = attention_bound(lens_np, C, T, H, D, dtype)
            log(f"[kernels] paged_attention {name}: {ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
                f"sdpa {lib_ms:.4f} ms (sdpa max_abs_err {lib_err:.2e})")
            variants.append({
                "dtype": str(dtype).split(".")[-1], "C": C,
                "max_abs_err": err, "tol": TOL[dtype], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms})
        del k_slab, v_slab
    kernels.reset_launch_counts()   # comparison launches do not count
    return variants, lens_np.tolist()


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------
def make_prompts():
    rng = np.random.RandomState(1)
    sizes = np.linspace(16, 1500, SLOTS).astype(int)
    rng.shuffle(sizes)
    return [rng.randint(1, FULL["vocab"], size=int(n)).tolist()
            for n in sizes]


def serve_run(dtype, prompts):
    cfg = serve.DecoderConfig(**FULL, dtype=dtype)
    model = serve.CachedDecoder(cfg, seed=0)
    eng = serve.ContinuousEngine(model, max_slots=SLOTS,
                                 prefill_window=WINDOW,
                                 decode_steps=DECODE_STEPS)
    eng.start()
    log(f"[serve {dtype}] warmup (kernel load, library init) "
        f"{eng.warmup_s:.3f} s")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    outs = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    eng.close()
    for p, o in zip(prompts, outs):
        assert o.dtype == np.int32 and o.shape == (NEW_TOKENS,), \
            f"prompt of {len(p)} tokens gave {o.shape} tokens"
        assert ((o >= 0) & (o < cfg.vocab)).all(), "token id out of range"
    want = cfg.layers * (eng.decode_steps * st["decode_iterations"]
                         + st["chunk_batches"])
    got = launches["paged_attention"]
    log(f"[serve {dtype}] paged_attention launches {got} (expected "
        f"{cfg.layers} layers x ({eng.decode_steps} steps x "
        f"{st['decode_iterations']} decode waves + {st['chunk_batches']} "
        f"chunk waves) = {want})")
    assert got == want and got > 0, "kernel launch count off the main path"
    return model, outs, st, wall, launches


def phase_serve(card):
    prompts = make_prompts()
    log(f"[serve] {len(prompts)} greedy requests, prompt lengths "
        f"{sorted(len(p) for p in prompts)}, {NEW_TOKENS} new tokens each")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, outs, st, wall, launches = serve_run("bfloat16", prompts)
    gen_tokens = len(prompts) * NEW_TOKENS
    log(f"[serve bfloat16] {card}: {wall:.3f} s for {gen_tokens} tokens "
        f"({gen_tokens / wall:.1f} tokens/s end to end), decode "
        f"{st['decode_tokens_per_sec']} tokens/s; TTFT p50 "
        f"{st['ttft_p50_ms']} ms p99 {st['ttft_p99_ms']} ms; TPOT p50 "
        f"{st['tpot_p50_ms']} ms p99 {st['tpot_p99_ms']} ms; "
        f"{st['decode_iterations']} decode waves, {st['chunk_batches']} "
        f"chunk waves, {st['prefill_batches']} prefill waves")
    # finite logits of the expected shape from the windowed prefill
    pool = model.new_pool(1)
    toks = torch.as_tensor(np.asarray(prompts[0][:WINDOW] + [0] * max(
        0, WINDOW - len(prompts[0])), dtype=np.int32)[None], device="cuda")
    n = torch.as_tensor([min(WINDOW, len(prompts[0]))], dtype=torch.int32,
                        device="cuda")
    logits = model.prefill_program(WINDOW)(
        model.params, *pool.buffers(), toks, n,
        torch.zeros(1, dtype=torch.int32, device="cuda"))
    assert logits.shape == (1, FULL["vocab"]) and \
        torch.isfinite(logits.float()).all(), "prefill logits not finite"
    bf16_exact = sum(int(np.array_equal(
        o, model.reference_generate(p, NEW_TOKENS, window=WINDOW)))
        for p, o in zip(prompts, outs))
    log(f"[serve bfloat16] {bf16_exact}/{len(prompts)} requests equal the "
        f"1-slot reference (bf16 greedy may part at near-ties; the exact "
        f"check is the float32 run)")
    del model, pool
    torch.cuda.empty_cache()
    model32, outs32, st32, wall32, _ = serve_run("float32", prompts)
    bad = [len(p) for p, o in zip(prompts, outs32) if not np.array_equal(
        o, model32.reference_generate(p, NEW_TOKENS, window=WINDOW))]
    log(f"[serve float32] {len(prompts) - len(bad)}/{len(prompts)} requests "
        f"token-exact against the 1-slot reference_generate "
        f"({wall32:.3f} s)")
    assert not bad, f"engine != reference for prompts of lengths {bad}"
    return {"wall_s": wall, "tokens": gen_tokens, "launches": launches,
            "stats": st, "bf16_exact": bf16_exact,
            "float32_exact": len(prompts)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every result to this JSON "
                    "file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[setup] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"[setup] kernel build {time.perf_counter() - t0:.2f} s "
        f"({', '.join(built) or 'up to date'})")
    for name, text in kernels.BUILD_LOG.items():
        print(f"[setup] nvcc {name}:\n{text}", file=sys.stderr)

    variants, lens = phase_kernels(dev)
    result = phase_serve(card)

    head = next(v for v in variants if v["dtype"] == "bfloat16"
                and v["C"] == 1)
    entry = {
        "name": "paged_attention", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "incubator_mxnet_tpu/ops/pallas_kernels.py:292",
        "launches": result["launches"]["paged_attention"],
        "max_abs_err": max(v["max_abs_err"] for v in variants
                           if v["dtype"] == "bfloat16"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"S={SLOTS} C=1 H={FULL['heads']} D={FULL['head_dim']} "
                 f"T={FULL['max_len']} bfloat16, lengths {lens}",
        "variants": variants,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": [entry],
                       "serve": result}, f, indent=1, default=str)
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
