"""GPT-2 as plain functions over a dict of stacked parameter tensors.

Counterpart of ``zig_gpt2_tpu.models.gpt2``, main serving path, float or
INT8/INT4 weights, float or INT8 KV cache:

- Parameters mirror the JAX pytree: every per-block leaf carries a leading
  ``n_layers`` axis, linears are ``(in, out)``, Q/K/V are separate. The
  layer loop is a Python loop over views ``w[idx]`` (no copies).
- The KV cache is ``{"k", "v": (L, B, H, S, D), "length": (B,) int32}``,
  unpacked; an INT8 cache (``init_kv_cache(quant="int8")``) holds int8
  ``k``/``v`` and f32 per-(token, head) scale planes ``k_scale``/``v_scale``
  (L, B, H, S). ``prefill`` and ``decode_step`` update it IN PLACE and
  return the same dict: the PyTorch analogue of the JAX package donating
  the cache to jit. A caller that needs the old cache must clone it first.
- Ring cache (``config.ring_cache``, the continuous batcher's layout): a
  lane's ``length`` rows are the interval [start, start + length) mod S,
  and every lane's next row goes to one shared write row ``wptr``; the
  cache adds ``start`` (B,) int32 and ``wptr`` 0-d int32, both kept on the
  cache's device (read on the host they would cost a sync per layer).
  ``prefill`` stays linear; the batcher rotates its lanes in on admission.
- ``decode_step`` runs the deferred order of the JAX kernel path: each
  layer attends over the ``length`` old rows plus the current token's K/V
  as a self-term (``ops.attention.decode_attention_deferred``, or
  ``decode_attention_quant_deferred`` over the current rows already
  quantized: the CUDA kernel on the card, its plain version on the CPU;
  with ``start=`` under the ring), then appends the row. The kernel never
  reads the row it appends.
- A linear stored quantized (``quant.quantize``) runs ``quantized_linear``
  (the dequant-GEMV kernel ``qmm`` up to 256 rows); the layer loop passes
  it the views ``qw[idx]``/``scale[idx]``, which copy nothing.
- The lm_head is tied to wte unless ``params["lm_head"]`` exists (the
  quantized tree unties it), and runs only on the positions that need
  logits; padded vocab rows are masked.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.ops import layers as ops
from zig_gpt2_tpu_torch.ops.attention import (decode_attention_deferred,
                                              decode_attention_quant_deferred)
from zig_gpt2_tpu_torch.quant.quantize import is_quantized, quantized_linear

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Parameter and cache initialization
# ---------------------------------------------------------------------------

def init_params(config: GPTConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random GPT-2 initialization (N(0, 0.02); residual projections scaled
    by 1/sqrt(2 L)), drawn from ``generator`` on its device."""
    E, L = config.n_embed, config.n_layers
    A = config.attn_heads * config.head_dim
    dev = generator.device

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (t * std).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    proj_std = 0.02 / (2.0 * L) ** 0.5
    return {
        "wte": normal((config.vocab_rows, E)),
        "wpe": normal((config.context_size, E), std=0.01),
        "blocks": {
            "ln_1": {"w": ones(L, E), "b": zeros(L, E)},
            "attn": {
                "wq": {"w": normal((L, E, A)), "b": zeros(L, A)},
                "wk": {"w": normal((L, E, A)), "b": zeros(L, A)},
                "wv": {"w": normal((L, E, A)), "b": zeros(L, A)},
                "c_proj": {"w": normal((L, A, E), std=proj_std), "b": zeros(L, E)},
            },
            "ln_2": {"w": ones(L, E), "b": zeros(L, E)},
            "mlp": {
                "c_fc": {"w": normal((L, E, 4 * E)), "b": zeros(L, 4 * E)},
                "c_proj": {"w": normal((L, 4 * E, E), std=proj_std), "b": zeros(L, E)},
            },
        },
        "ln_f": {"w": ones(E), "b": zeros(E)},
    }


def init_kv_cache(config: GPTConfig, batch_size: int = 1,
                  max_seq: Optional[int] = None,
                  dtype: torch.dtype = torch.float32,
                  device="cpu", quant: Optional[str] = None,
                  ring: Optional[bool] = None) -> KVCache:
    """Preallocate the fixed-shape KV cache, unpacked layout: float in
    ``dtype``, or with ``quant="int8"`` int8 rows with f32 per-(token,
    head) scale planes (``dtype`` is then unused). A ring cache
    (``config.ring_cache``, or ``ring`` when given: ``ring=False`` builds
    the linear lane caches that admissions prefill under a ring config)
    adds ``start`` (B,) and ``wptr`` (), int32, zero."""
    if config.kv_packed:
        raise NotImplementedError("the packed KV cache is not ported (it comes, "
                                  "with its per-pair INT8 scales, with a later "
                                  "slice)")
    if quant not in (None, "int8"):
        raise ValueError(f"unknown KV quantization {quant!r}")
    max_seq = max_seq or config.context_size
    shape = (config.n_layers, batch_size, config.attn_heads, max_seq, config.head_dim)
    cache = {"length": torch.zeros((batch_size,), dtype=torch.int32, device=device)}
    if quant == "int8":
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[name + "_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                                 device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if config.ring_cache if ring is None else ring:
        cache["start"] = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        cache["wptr"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Apply one (already layer-sliced) linear, float or quantized."""
    if is_quantized(p):
        return quantized_linear(p, x)
    return ops.linear(x, p["w"], p.get("b"))


def _layer(tree: Params, idx: int) -> Params:
    """Views of every (L, ...) leaf of a stacked subtree at layer idx."""
    return {k: _layer(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def _qkv(attn_p: Params, h: torch.Tensor, n_heads: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., E) -> three (..., H, D) projections."""

    def heads(t):
        return t.reshape(*t.shape[:-1], n_heads, t.shape[-1] // n_heads)

    return (heads(_linear(attn_p["wq"], h)), heads(_linear(attn_p["wk"], h)),
            heads(_linear(attn_p["wv"], h)))


def _block_prefill(x: torch.Tensor, bp: Params, config: GPTConfig,
                   length_mask: Optional[torch.Tensor]):
    """One block over a full sequence: returns (x, k, v), k/v (B, H, T, D)."""
    B, T, _ = x.shape
    h = ops.layer_norm(x, bp["ln_1"]["w"], bp["ln_1"]["b"], config.layer_norm_eps)
    q, k, v = (t.transpose(1, 2) for t in _qkv(bp["attn"], h, config.attn_heads))
    attn = ops.causal_attention(q, k, v, length_mask=length_mask)
    attn = attn.transpose(1, 2).reshape(B, T, -1)
    x = x + _linear(bp["attn"]["c_proj"], attn)
    h = ops.layer_norm(x, bp["ln_2"]["w"], bp["ln_2"]["b"], config.layer_norm_eps)
    h = ops.gelu(_linear(bp["mlp"]["c_fc"], h))
    x = x + _linear(bp["mlp"]["c_proj"], h)
    return x, k, v


def _put_row_stacked(stack: torch.Tensor, row: torch.Tensor, idx: int,
                     pos: torch.Tensor) -> None:
    """Write (B, H, D) rows into the stacked (L, B, H, S, D) cache at
    (idx, b, :, pos[b], :), or (B, H) scales into a stacked (L, B, H, S)
    plane at (idx, b, :, pos[b]), in place, with one indexed write. A 0-d
    ``pos`` (the ring's shared write row) puts every lane's row at that one
    row with one ``index_copy_``, the index staying on the device."""
    if pos.dim() == 0:
        stack[idx].index_copy_(2, pos.view(1).long(), row.unsqueeze(2).to(stack.dtype))
        return
    lanes = torch.arange(row.shape[0], device=stack.device)
    stack[idx, lanes, :, pos.long()] = row.to(stack.dtype)


def _block_decode(x: torch.Tensor, blocks: Params, idx: int, caches: KVCache,
                  pos: torch.Tensor, start: Optional[torch.Tensor],
                  wpos: torch.Tensor, config: GPTConfig) -> torch.Tensor:
    """One block for one decode token per lane. ``pos`` (B,) is each lane's
    count of valid cache rows: the prefix [0, pos), or with ``start`` the
    ring interval. ``wpos`` is the row this token's K/V is written to, per
    lane (B,) or shared (). Attends first (deferred), then appends in
    place."""
    bp = _layer(blocks, idx)
    h = ops.layer_norm(x, bp["ln_1"]["w"], bp["ln_1"]["b"], config.layer_norm_eps)
    q, k, v = _qkv(bp["attn"], h, config.attn_heads)  # (B, H, D)
    if "k_scale" in caches:  # INT8 cache: quantize, attend, then append
        (kq, ks), (vq, vs) = ops.quantize_kv(k), ops.quantize_kv(v)
        attn = decode_attention_quant_deferred(
            q, kq, ks, vq, vs, caches["k"], caches["k_scale"], caches["v"],
            caches["v_scale"], pos, layer=idx, start=start)
        for name, row in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
            _put_row_stacked(caches[name], row, idx, wpos)
    else:
        attn = decode_attention_deferred(q, k, v, caches["k"], caches["v"], pos,
                                         layer=idx, start=start)
        _put_row_stacked(caches["k"], k, idx, wpos)
        _put_row_stacked(caches["v"], v, idx, wpos)
    x = x + _linear(bp["attn"]["c_proj"], attn.reshape(x.shape[0], -1))
    h = ops.layer_norm(x, bp["ln_2"]["w"], bp["ln_2"]["b"], config.layer_norm_eps)
    h = ops.gelu(_linear(bp["mlp"]["c_fc"], h))
    return x + _linear(bp["mlp"]["c_proj"], h)


def _lm_head(params: Params, x: torch.Tensor, config: GPTConfig) -> torch.Tensor:
    """logits = x @ wte^T, or ``params["lm_head"]`` (untied, quantized by
    ``quantize_params``) when present; padded vocab rows are masked."""
    if "lm_head" in params:
        logits = _linear(params["lm_head"], x)
    else:
        logits = torch.matmul(x, params["wte"].T)
    if config.padded_vocab_size is not None:
        ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(ids >= config.vocab_size, ops.MASK_VALUE)
    return logits


def _embed(params: Params, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return (ops.embedding(tokens.long(), params["wte"])
            + ops.embedding(pos.long(), params["wpe"]))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(params: Params, tokens: torch.Tensor, config: GPTConfig) -> torch.Tensor:
    """Full-sequence forward: (B, T) tokens -> (B, T, vocab) logits."""
    T = tokens.shape[1]
    x = _embed(params, tokens, torch.arange(T, device=tokens.device))
    for idx in range(config.n_layers):
        x, _, _ = _block_prefill(x, _layer(params["blocks"], idx), config, None)
    x = ops.layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"], config.layer_norm_eps)
    return _lm_head(params, x, config)


@torch.no_grad()
def prefill(params: Params, cache: KVCache, tokens: torch.Tensor,
            lengths: torch.Tensor, config: GPTConfig) -> Tuple[KVCache, torch.Tensor]:
    """Run a right-padded (B, T) prompt batch with true ``lengths`` (B,)
    through the model, writing rows [0, T) of every layer's cache in place
    (rows at or past a lane's length are padding that no read reaches and
    the next decode steps overwrite). Returns (cache, (B, vocab) logits at
    each lane's last prompt position)."""
    B, T = tokens.shape
    pos = torch.arange(T, device=tokens.device)
    x = _embed(params, tokens, pos)
    lengths = lengths.to(device=tokens.device, dtype=torch.int32)
    length_mask = pos[None, :] < lengths[:, None]
    for idx in range(config.n_layers):
        x, k, v = _block_prefill(x, _layer(params["blocks"], idx), config, length_mask)
        if "k_scale" in cache:  # INT8 cache: quantize on append
            (k, ks), (v, vs) = ops.quantize_kv(k), ops.quantize_kv(v)
            cache["k_scale"][idx, :, :, :T] = ks
            cache["v_scale"][idx, :, :, :T] = vs
        cache["k"][idx, :, :, :T] = k.to(cache["k"].dtype)
        cache["v"][idx, :, :, :T] = v.to(cache["v"].dtype)
    x = ops.layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"], config.layer_norm_eps)
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    cache["length"] = lengths.clone()
    return cache, _lm_head(params, last, config)


@torch.no_grad()
def decode_step(params: Params, cache: KVCache, tokens: torch.Tensor,
                config: GPTConfig) -> Tuple[KVCache, torch.Tensor]:
    """One autoregressive step: (B,) tokens -> (cache, (B, vocab) logits).
    The cache is updated in place (see the module docstring).

    A lane may run past its window while idle (the batcher keeps decoding
    a retired slot and discards its tokens); its position embedding index
    clamps at the table's last row and, in a linear cache, its write row at
    the cache's last row, as the JAX package's dynamic_update_slice
    clamps. Under the ring the length clamps at rows - 1, so an interval
    never reaches the write row, and ``wptr`` advances by one."""
    pos = cache["length"]
    rows = cache["k"].shape[-2]
    x = _embed(params, tokens, pos.clamp(max=params["wpe"].shape[0] - 1))
    if config.ring_cache:
        start, wpos = cache["start"], cache["wptr"]
    else:
        start, wpos = None, pos.clamp(max=rows - 1)
    for idx in range(config.n_layers):
        x = _block_decode(x, params["blocks"], idx, cache, pos, start, wpos, config)
    x = ops.layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"], config.layer_norm_eps)
    if config.ring_cache:
        cache["length"] = (pos + 1).clamp(max=rows - 1)
        cache["wptr"] = (wpos + 1) % rows
    else:
        cache["length"] = pos + 1
    return cache, _lm_head(params, x, config)
