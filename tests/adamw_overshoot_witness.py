"""Witness for the learning rate of ``chip_smoke.py``'s training phase.

At optax's default AdamW settings (lr 3e-4, no warmup) five steps on one
fixed batch do not lower the loss at every step at GPT-2 124M width: the
first update moves every weight by about lr * sign(g), and the loss falls,
then overshoots. This script shows that the JAX package's ``train_step``
does the same as the port's, on the CPU, at 124M width and reduced depth
(default 6 of 12 layers; 2 layers stay monotone), on the batch recipe of
the card's phase (the demo text through an in-process BPE, each row from
another offset). It prints both loss curves and exits 1 when they differ
by more than 1e-5 relative at any step.

    JAX_PLATFORMS=cpu python tests/adamw_overshoot_witness.py [--layers 6]
"""

import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (DEMO_TEXT: the card's training batch)
from zig_gpt2_tpu import train as jtrain  # noqa: E402
from zig_gpt2_tpu.config import GPT2_124M  # noqa: E402
from zig_gpt2_tpu.models import gpt2 as jgpt2  # noqa: E402
from zig_gpt2_tpu_torch import config as tconfig  # noqa: E402
from zig_gpt2_tpu_torch import tokenizer as tok  # noqa: E402
from zig_gpt2_tpu_torch import train as ttrain  # noqa: E402
from zig_gpt2_tpu_torch.weights import params_from_numpy  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    jax.config.update("jax_default_matmul_precision", "highest")
    jcfg = dataclasses.replace(GPT2_124M, n_layers=args.layers)
    tcfg = dataclasses.replace(tconfig.get_config("124M"), n_layers=args.layers)
    vocab, merges = tok.train_bpe(chip_smoke.DEMO_TEXT, vocab_size=512)
    text = tok.Encoder(vocab, merges).encode(chip_smoke.DEMO_TEXT)
    B, T = args.batch, args.seq
    stream = text * (-(-(B * 37 + T + 1) // len(text)))
    tokens = np.array([stream[37 * r:37 * r + T + 1] for r in range(B)], np.int32)

    jp = jgpt2.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    opt = jtrain.make_optimizer()
    state = opt.init(jp)
    step = jtrain.make_train_step(jcfg, opt)
    jl = []
    for _ in range(args.steps):
        jp, state, loss = step(jp, state, jnp.asarray(tokens))
        jl.append(float(loss))
    topt = ttrain.make_optimizer(tp)
    tstep = ttrain.make_train_step(tcfg)
    tl = [tstep(tp, topt, torch.from_numpy(tokens))[2].item() for _ in range(args.steps)]
    gap = max(abs(a - b) / abs(a) for a, b in zip(jl, tl))
    print(f"124M width, {args.layers} layers, B={B}, T={T}, AdamW lr 3e-4 (optax defaults), "
          f"CPU:\n  JAX  losses {jl}\n  port losses {tl}\n  largest relative gap {gap:.3e}; "
          f"falls at every step: JAX {all(a > b for a, b in zip(jl, jl[1:]))}, "
          f"port {all(a > b for a, b in zip(tl, tl[1:]))}")
    return 0 if gap <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
