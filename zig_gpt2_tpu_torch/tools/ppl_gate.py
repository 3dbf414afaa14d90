"""One-command quantization perplexity gate (BASELINE.md graded metric).

The port's counterpart of ``zig_gpt2_tpu.tools.ppl_gate``: given FP32
weights and an eval corpus, prints the FP32 / INT8 / w8a8 / INT4
perplexity table and pass/fail against the budgets (Δ ≤ 0.1 at INT8 and
w8a8, Δ ≤ 0.5 at INT4, vs FP32), then one JSON line, and exits non-zero on
any failure:

    python -m zig_gpt2_tpu_torch.tools.ppl_gate --model 124M \\
        --weights models/124M/raw --encoder-dir models/124M \\
        --corpus wiki.test.tokens

It runs on the card (``--device cuda``, the default; fp32 without TF32),
and with no card it exits with an error unless ``--device cpu`` is given.
``--demo`` runs the same pipeline on a small random model (GPT2_MICRO) and
a synthetic corpus.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

# (mode, budget) rows of the gate table. w8a8 (per-channel INT8 weights and
# per-row INT8 activations) is held to the INT8 budget.
GATES = (("int8", 0.1), ("w8a8", 0.1), ("int4", 0.5))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="124M")
    p.add_argument("--weights", default=None, help="raw FP32 checkpoint dir")
    p.add_argument("--encoder-dir", default=None,
                   help="dir with encoder.json (+ vocab.bpe) for raw-text corpora")
    p.add_argument("--corpus", default=None,
                   help="eval tokens: .npy/.bin of int32 ids, or raw text "
                        "(e.g. WikiText-2 wiki.test.tokens)")
    p.add_argument("--window", type=int, default=None,
                   help="PPL context window (default: model context)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--modes", default="int8,w8a8,int4",
                   help="comma-separated quantization modes to gate")
    p.add_argument("--demo", action="store_true",
                   help="tiny random model + synthetic corpus (no weights)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch

    from zig_gpt2_tpu_torch.config import get_config
    from zig_gpt2_tpu_torch.eval.perplexity import load_tokens, perplexity
    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.quant import quantize as q

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("error: no CUDA device (pass --device cpu to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.demo:
        from zig_gpt2_tpu_torch.config import GPT2_MICRO

        config = get_config(args.model) if args.model not in ("124M",) else GPT2_MICRO
        gen = torch.Generator(device=args.device).manual_seed(0)
        params = gpt2.init_params(config, gen, torch.float32)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, config.vocab_size, 4096).astype(np.int32)
        window = args.window or 128
    else:
        if not (args.weights and args.corpus):
            p.error("--weights and --corpus required (or --demo)")
        from zig_gpt2_tpu_torch.utils import io as zio

        config = get_config(args.model)
        params = zio.load_gpt2_raw(args.weights, config, dtype=torch.float32,
                                   device=args.device)
        encoder = None
        if args.encoder_dir:
            from pathlib import Path

            from zig_gpt2_tpu_torch.tokenizer import Encoder

            d = Path(args.encoder_dir)
            bpe = d / "vocab.bpe"
            encoder = Encoder.from_files(d / "encoder.json", bpe if bpe.exists() else None,
                                         mode="bpe" if bpe.exists() else "greedy")
        tokens = load_tokens(args.corpus, encoder)
        window = args.window

    kw = dict(window=window, batch_size=args.batch)
    ppl_fp = perplexity(params, config, tokens, **kw)
    rows = [{"mode": "fp32", "ppl": ppl_fp, "delta": 0.0, "budget": None, "pass": True}]
    ok = True
    wanted = [m.strip() for m in args.modes.split(",") if m.strip()]
    for mode, budget in GATES:
        if mode not in wanted:
            continue
        cfg = dataclasses.replace(config, act_quant=True) if mode == "w8a8" else config
        qp = q.quantize_params(params, mode="int8" if mode == "w8a8" else mode)
        ppl = perplexity(qp, cfg, tokens, **kw)
        delta = ppl - ppl_fp
        passed = delta <= budget
        ok &= passed
        rows.append({"mode": mode, "ppl": ppl, "delta": delta, "budget": budget,
                     "pass": passed})

    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"ppl_gate device: {where}", file=sys.stderr)
    print(f"{'mode':<6} {'ppl':>12} {'Δ vs fp32':>12} {'budget':>8}  gate")
    for r in rows:
        budget = f"{r['budget']:.1f}" if r["budget"] is not None else "—"
        verdict = "PASS" if r["pass"] else "FAIL"
        print(f"{r['mode']:<6} {r['ppl']:>12.4f} {r['delta']:>12.4f} {budget:>8}  {verdict}")
    print(json.dumps({"gate": "ppl", "tokens": int(np.asarray(tokens).size), "rows": rows,
                      "pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
