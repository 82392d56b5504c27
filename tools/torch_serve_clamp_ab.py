"""Cost of the clamped embedding gathers on the port's serving hot path.

`serve/continuous.py::_embed` clamps each token id into the vocabulary
before the embedding gather of the prefill, chunk-prefill, decode and
speculative-decode step programs (a where and a clamp more a gather). This
script runs `chip_smoke.py`'s phase 3 (16 greedy requests, bfloat16) and
phase 9 (the full engine: int8 pool, prefix cache, speculative decode)
workloads with `_embed` as shipped ("clamp") and with the plain index it
replaced ("plain"), alternating clamp, plain, plain, clamp in one process on
one card, and prints TPOT p50/p99 and decode tokens/s of each run, then one
JSON line with every reading. Run from the repo root on a CUDA machine:

    python3 tools/torch_serve_clamp_ab.py [--rounds 2]
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch.ops import kernels  # noqa: E402
from incubator_mxnet_tpu_torch.serve import continuous  # noqa: E402


def _plain_embed(params, tokens):
    return params["emb"][tokens.long()]


def _reading(st):
    return {k: st[k] for k in ("tpot_p50_ms", "tpot_p99_ms", "ttft_p50_ms",
                               "decode_tokens_per_sec")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="clamp/plain pairs, each run as clamp, plain, "
                         "plain, clamp")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    kernels.build(["paged_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shipped = continuous._embed
    prompts, traffic = cs.make_prompts(), cs.engine_traffic()
    order = ["clamp", "plain", "plain", "clamp"] * (args.rounds // 2) \
        + ["clamp", "plain"] * (args.rounds % 2)
    runs = []
    for arm in order:
        continuous._embed = shipped if arm == "clamp" else _plain_embed
        try:
            _, outs3, st3, _, _ = cs.serve_run("bfloat16", prompts)
            _, _, outs9, st9, _, _ = cs.engine_run("bfloat16", traffic)
        finally:
            continuous._embed = shipped
        run = {"arm": arm, "phase3": _reading(st3), "phase9": _reading(st9),
               "tokens": [o.tolist() for o in outs3[:2]]}
        runs.append(run)
        print(f"[{arm}] phase 3 TPOT p50 {st3['tpot_p50_ms']} ms p99 "
              f"{st3['tpot_p99_ms']} ms, decode "
              f"{st3['decode_tokens_per_sec']} tokens/s; phase 9 TPOT p50 "
              f"{st9['tpot_p50_ms']} ms p99 {st9['tpot_p99_ms']} ms, decode "
              f"{st9['decode_tokens_per_sec']} tokens/s", flush=True)
    same = all(r["tokens"] == runs[0]["tokens"] for r in runs)
    print(f"greedy tokens the same in every run: {same}")
    print(json.dumps({"card": card, "runs": [
        {k: v for k, v in r.items() if k != "tokens"} for r in runs]}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
