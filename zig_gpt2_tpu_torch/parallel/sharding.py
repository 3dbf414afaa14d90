"""Padding for tensor parallelism.

The port's counterpart of ``zig_gpt2_tpu.parallel.sharding``. GPT-2's dims
do not always divide the model-parallel degree: 1.5B has 25 heads and every
size has a vocab of 50257. ``pad_for_tp`` pads the parameter tree so that
the head and vocab axes divide ``tp`` without changing the model's
function:

- extra heads get zero wq/wk/wv columns (and biases) and zero c_proj rows:
  their attention output is a convex combination of zero value rows, which
  the zero c_proj rows then meet;
- extra vocab rows get zero embeddings, and the model masks their logits
  (``models.gpt2._lm_head``), so sampling never draws them.

A quantized tree cannot be padded after the fact (the INT4 half-split
packing and the scale groups do not survive inserted rows): quantize after
padding (``quant.quantize.quantize_params(tp=)``), as the CLI and
``tools.repack --tp`` do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch.nn.functional as F

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.quant.quantize import is_quantized


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_dims(config: GPTConfig, tp: int, vocab_multiple: int = 128) -> Tuple[int, int]:
    """(padded heads, padded vocab) for a model-parallel degree ``tp``:
    heads rounded up to a multiple of tp, the vocab to a multiple of
    lcm(tp, vocab_multiple), from the dims the tree holds (the JAX
    package's from an unpadded config; a tree padded for another degree,
    e.g. by ``repack --tp 8`` served over tp=2, keeps rows that already
    divide)."""
    return (_round_up(config.attn_heads, tp),
            _round_up(config.vocab_rows, math.lcm(tp, vocab_multiple)))


def pad_for_tp(params: Dict[str, Any], config: GPTConfig,
               tp: int) -> Tuple[Dict[str, Any], GPTConfig]:
    """(params, config) with the head and vocab axes padded to divide
    ``tp``. Returns the inputs as they are when both already divide
    (idempotent). Raises ValueError when n_embed or 4 n_embed does not
    divide by tp, or when a quantized tree would need padding."""
    heads, vocab = padded_dims(config, tp)
    if config.n_embed % tp or (4 * config.n_embed) % tp:
        raise ValueError(f"n_embed {config.n_embed} not divisible by tp={tp}")
    if heads == config.attn_heads and vocab == config.vocab_rows:
        return params, config
    blocks = params["blocks"]
    if "lm_head" in params or any(is_quantized(blocks[mod][name])
                                  for mod, names in (("attn", ("wq", "wk", "wv", "c_proj")),
                                                     ("mlp", ("c_fc", "c_proj")))
                                  for name in names if name in blocks[mod]):
        raise ValueError("cannot pad a quantized checkpoint for this mesh: requantize from "
                         "float weights after padding (the CLI's order: load, pad_for_tp, "
                         "quantize_params(tp=tp))")
    new_cfg = dataclasses.replace(
        config,
        padded_heads=heads if heads != config.n_heads else config.padded_heads,
        padded_vocab_size=vocab if vocab != config.vocab_size else config.padded_vocab_size)
    extra = (heads - config.attn_heads) * config.head_dim
    params = dict(params)
    if extra:
        attn = dict(blocks["attn"])
        for name in ("wq", "wk", "wv"):
            attn[name] = {"w": F.pad(attn[name]["w"], (0, extra)),
                          "b": F.pad(attn[name]["b"], (0, extra))}
        attn["c_proj"] = {"w": F.pad(attn["c_proj"]["w"], (0, 0, 0, extra)),
                          "b": attn["c_proj"]["b"]}
        params["blocks"] = dict(blocks, attn=attn)
    if vocab != config.vocab_rows:
        params["wte"] = F.pad(params["wte"], (0, 0, 0, vocab - config.vocab_rows))
    return params, new_cfg
