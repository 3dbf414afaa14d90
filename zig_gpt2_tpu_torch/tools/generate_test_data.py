"""Golden test-data generator — reference-interchange file set.

The port's copy of ``zig_gpt2_tpu.tools.generate_test_data`` (the
reference's generate_test_data.py): forwards random tensors through
PyTorch ops and dumps raw headerless binaries to ``models/test/``,
emitting exactly the file names and layouts the reference's Zig test
suite consumes (the ``name_to_tensor`` keys of the reference's
generate_test_data.py, read by tests.zig), byte for byte the files the
JAX package's copy writes for the same seed.

Layout notes for interchange fidelity:

- linear weights are dumped in nn.Linear's (out, in) layout — the layout
  the reference's ops.zig:9 expects ("pre-transposed").
- ``embedding_inputs`` is raw int64 token ids (torch.randint default),
  matching the reference dump; everything else is float32.
- the attention goldens are one derivation chain: ``attn_inputs`` →
  c_attn → split/reshape (``sdpa_q/k/v``) → masked SDPA
  (``sdpa_outputs``) → merge → c_proj (``attn_outputs``) — tests.zig
  feeds the chain's input through its incremental KV-cache decode and
  checks against the full-sequence outputs.

    python -m zig_gpt2_tpu_torch.tools.generate_test_data --out models/test
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np


def write_golden_files(out: Path, seed: int = 0) -> dict:
    """Dump the full reference golden set to ``out``; returns
    {name: shape} for every file written (shape as the reader must supply
    it — the raw format is headerless)."""
    import torch
    import torch.nn.functional as F

    from zig_gpt2_tpu_torch.utils.io import save_tensor

    torch.manual_seed(seed)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    shapes: dict = {}

    def dump(name: str, t: torch.Tensor) -> None:
        arr = t.detach().numpy()
        if not np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32)
        save_tensor(out / name, arr)
        shapes[name] = tuple(arr.shape)

    B, E = 3, 768

    # Linear, with and without bias, sharing one weight. nn.Linear layout:
    # w (out, in), y = x @ w.T + b.
    x = torch.randn(B, E)
    lw = torch.randn(4 * E, E) / math.sqrt(E)
    lb = torch.randn(4 * E)
    dump("linear_inputs", x)
    dump("linear_weight", lw)
    dump("linear_bias", lb)
    dump("linear_outputs", x @ lw.T + lb)
    dump("linear_outputs_no_bias", x @ lw.T)

    # GELU (tanh approximation — the reference formula, ops.zig:224).
    g_in = torch.randn(B, E)
    dump("gelu_inputs", g_in)
    dump("gelu_outputs", F.gelu(g_in, approximate="tanh"))

    # Softmax.
    s_in = torch.randn(B, E)
    dump("softmax_inputs", s_in)
    dump("softmax_outputs", F.softmax(s_in, dim=-1))

    # Embedding: inputs are RAW INT64 token ids (the reference dumps
    # torch.randint's default dtype; tests.zig reads them as i64).
    emb_w = torch.randn(10, E)
    idx = torch.randint(0, 10, (B,))
    dump("embedding_weight", emb_w)
    dump("embedding_inputs", idx)
    dump("embedding_outputs", emb_w[idx])

    # LayerNorm (eps 1e-5, affine — ops.zig:70-105).
    ln_in = torch.randn(B, E)
    ln_w, ln_b = torch.randn(E), torch.randn(E)
    dump("layer_norm_inputs", ln_in)
    dump("layer_norm_weight", ln_w)
    dump("layer_norm_bias", ln_b)
    dump("layer_norm_outputs", F.layer_norm(ln_in, (E,), ln_w, ln_b, eps=1e-5))

    # Attention-shape intermediates (reference: batch 1, seq 5, 12 heads).
    b, T, H, D = 1, 5, 12, 64
    n_embed = H * D

    # (B, T, H, D) <-> (B, H, T, D) transpose golden.
    tr_in = torch.randn(b, T, H, D)
    dump("transpose_inputs", tr_in)
    dump("transpose_outputs", tr_in.transpose(1, 2).contiguous())

    # Packed-QKV split golden.
    sp_in = torch.randn(b, T, 3 * n_embed)
    dump("split_inputs", sp_in)
    for name, part in zip(("split_q", "split_k", "split_v"),
                          sp_in.split(n_embed, dim=2)):
        dump(name, part.contiguous())

    # Full attention chain: c_attn -> split/heads -> masked SDPA -> c_proj.
    a_in = torch.randn(b, T, n_embed)
    caw = torch.randn(3 * n_embed, n_embed) / math.sqrt(n_embed)
    cab = torch.randn(3 * n_embed)
    dump("attn_inputs", a_in)
    dump("attn_c_attn_weight", caw)
    dump("attn_c_attn_bias", cab)
    qkv = a_in @ caw.T + cab
    q, k, v = (
        t.view(b, T, H, D).transpose(1, 2)
        for t in qkv.split(n_embed, dim=2)
    )
    scores = q @ k.transpose(-2, -1) / math.sqrt(D)
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool))
    probs = F.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    sdpa_out = probs @ v
    dump("sdpa_q", q.contiguous())
    dump("sdpa_k", k.contiguous())
    dump("sdpa_v", v.contiguous())
    dump("sdpa_outputs", sdpa_out.contiguous())

    cpw = torch.randn(n_embed, n_embed) / math.sqrt(n_embed)
    cpb = torch.randn(n_embed)
    dump("attn_c_proj_weight", cpw)
    dump("attn_c_proj_bias", cpb)
    merged = sdpa_out.transpose(1, 2).contiguous().view(b, T, n_embed)
    dump("attn_outputs", merged @ cpw.T + cpb)

    return shapes


# The reference suite's complete input set (generate_test_data.py
# name_to_tensor keys) — write_golden_files must emit a superset; main()
# asserts it.
REFERENCE_FILE_SET = frozenset({
    "linear_weight", "linear_bias", "linear_inputs", "linear_outputs",
    "linear_outputs_no_bias",
    "gelu_inputs", "gelu_outputs",
    "softmax_inputs", "softmax_outputs",
    "embedding_weight", "embedding_inputs", "embedding_outputs",
    "layer_norm_weight", "layer_norm_bias", "layer_norm_inputs",
    "layer_norm_outputs",
    "transpose_inputs", "transpose_outputs",
    "split_inputs", "split_q", "split_k", "split_v",
    "attn_inputs", "attn_c_attn_weight", "attn_c_attn_bias",
    "sdpa_q", "sdpa_k", "sdpa_v", "sdpa_outputs",
    "attn_c_proj_weight", "attn_c_proj_bias", "attn_outputs",
})


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="models/test")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    shapes = write_golden_files(Path(args.out), args.seed)
    missing = REFERENCE_FILE_SET - set(shapes)
    assert not missing, f"missing reference goldens: {sorted(missing)}"
    print(f"{len(shapes)} golden files written to {args.out}/")


if __name__ == "__main__":
    main()
