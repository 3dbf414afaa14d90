#!/usr/bin/env python3
"""End-to-end A/B of the KV cache layouts on one card, untraced.

    python3 zig_gpt2_tpu_torch/tools/layout_ab.py [--models 124M,1558M] [--out FILE]

For each model, the engine at B=1 and the continuous batcher are built on
the unpacked layout (``ZG2_KV_PACKED=0``) and on the packed one (``=1``)
in the order unpacked, packed, packed, unpacked, with the same weights and
requests, so that drift of the host over the run weighs on both layouts
alike. Each run prints one JSON line: the engine's ms/token p50 and
tokens/s per request, or the batcher's tokens/s and sync_ms p50/p99, and
whether its greedy tokens equal the other run of its layout.

Models (random weights from seed 0, the full vocab): GPT-2 124M fp32 with
a float cache (engine; batcher B=8, max_seq 256, 16 greedy requests of
prompts 4-100 and budgets 16-64); GPT-2 1.5B at full depth, bf16 with INT4
block linears and an INT8 lm_head, INT8 cache (engine; batcher B=16,
max_seq 256, decode_chunk 1, 32 greedy requests of prompts 8-120 and
budgets 32-96). Engine: two prompts (20 and 100 ids) x 32 greedy tokens.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ORDER = ("0", "1", "1", "0")  # ZG2_KV_PACKED per run: unpacked, packed, packed, unpacked


def requests(seed: int, n: int, vocab: int, prompt_lens, budgets):
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n)
    budgets = rng.integers(budgets[0], budgets[1] + 1, n)
    return [(rng.integers(0, vocab, m).tolist(), int(b)) for m, b in zip(lens, budgets)]


def build_model(name: str, torch):
    """(config, params, engine and batcher keyword arguments, batcher
    requests) of one model."""
    from zig_gpt2_tpu_torch import config as config_mod
    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.quant import quantize

    config = config_mod.get_config(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if name == "124M":
        params = gpt2.init_params(config, gen, torch.float32)
        return (config, params, {}, dict(batch_size=8, max_seq=256),
                requests(21, 16, config.vocab_size, (4, 100), (16, 64)))
    params = quantize.quantize_params(gpt2.init_params(config, gen, torch.bfloat16), "int4")
    return (config, params, {"kv_quant": "int8"},
            dict(batch_size=16, max_seq=256, decode_chunk=1, kv_quant="int8"),
            requests(31, 32, config.vocab_size, (8, 120), (32, 96)))


def run_engine(engine_mod, config_mod, config, params, kw, prompts, device="cuda") -> dict:
    """One engine run: a warm-up, then each prompt x 32 greedy tokens."""
    engine = engine_mod.InferenceEngine(config, params, device=device, **kw)
    greedy = config_mod.SamplingConfig(temperature=0.0)
    engine.generate([1, 2, 3], 2, greedy)
    out = {"kv_packed": engine.config.kv_packed, "ms_per_token_p50": [],
           "tokens_per_sec": [], "prefill_ms": [], "tokens": []}
    for ids in prompts:
        m = engine_mod.GenerationMetrics()
        out["tokens"].append(engine.generate(ids, 32, greedy, metrics=m))
        out["ms_per_token_p50"].append(m.ms_per_token_percentile(50))
        out["tokens_per_sec"].append(m.tokens_per_sec)
        out["prefill_ms"].append(m.prefill_ms)
    return out


def run_batcher(batcher_mod, config_mod, config, params, kw, reqs, device="cuda") -> dict:
    """One batcher run: a warm-up, then every request, greedy."""
    b = batcher_mod.ContinuousBatcher(config, params, device=device,
                                      sampling=config_mod.SamplingConfig(temperature=0.0),
                                      **kw)
    for ids, budget in ([1, 2, 3], 4), ([4, 5], 4):  # warm-up
        b.submit(ids, budget)
    b.run()
    b.metrics = batcher_mod.BatcherMetrics()
    rids = [b.submit(ids, budget) for ids, budget in reqs]
    by_rid = {r.rid: r.generated for r in b.run()}
    m = b.metrics.as_dict(b.batch_size)
    return {"kv_packed": b.config.kv_packed, "tokens_per_sec": m["tokens_per_sec"],
            "sync_ms_p50": m["sync_ms_p50"], "sync_ms_p99": m["sync_ms_p99"],
            "steps": m["steps"], "tokens_emitted": m["tokens_emitted"],
            "tokens": [by_rid[r] for r in rids]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="124M,1558M")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("layout_ab: no CUDA device", file=sys.stderr)
        return 1
    from zig_gpt2_tpu_torch import config as config_mod
    from zig_gpt2_tpu_torch.runtime import batcher as batcher_mod
    from zig_gpt2_tpu_torch.runtime import engine as engine_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    out = open(args.out, "a") if args.out else None
    for name in args.models.split(","):
        config, params, engine_kw, batcher_kw, reqs = build_model(name, torch)
        prompts = [ids for ids, _ in requests(7, 2, config.vocab_size, (20, 20), (1, 1))]
        prompts[1] = requests(8, 1, config.vocab_size, (100, 100), (1, 1))[0][0]
        seen = {}
        for i, layout in enumerate(ORDER):
            os.environ["ZG2_KV_PACKED"] = layout
            for kind in ("engine", "batcher"):
                if kind == "engine":
                    row = run_engine(engine_mod, config_mod, config, params, engine_kw,
                                     prompts)
                else:
                    row = run_batcher(batcher_mod, config_mod, config, params, batcher_kw,
                                      reqs)
                if row["kv_packed"] != (layout == "1"):
                    raise AssertionError(f"{name} {kind}: asked for ZG2_KV_PACKED={layout}, "
                                         f"got kv_packed={row['kv_packed']}")
                tokens = row.pop("tokens")
                same = seen.setdefault((kind, layout), tokens) == tokens
                line = json.dumps({"model": name, "kind": kind, "run": i,
                                   "layout": "packed" if layout == "1" else "unpacked",
                                   **row, "greedy_tokens_equal_to_first_run_of_layout": same,
                                   "card": card})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        del params
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
