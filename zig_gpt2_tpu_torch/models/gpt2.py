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
- Head-pair-packed cache (``config.kv_packed``, head_dim 64 only; the
  runtimes choose it by ``prepare_serving``): ``k``/``v`` are
  (L, B, Hp, S, 2D), two adjacent heads per row, with one zero phantom
  head when H is odd (Hp = ceil(H / 2)). The phantom head lives in the
  weights (``pad_phantom_head``, zero Q/K/V columns and c_proj rows, added
  once), so a packed step packs and unpacks views only; ``prefill`` and
  ``decode_step`` refuse a packed config with an odd head count. An INT8
  cache quantizes the packed rows, so its scales are per head pair, planes
  (L, B, Hp, S): the JAX package's packed quantization, which differs from
  the unpacked one.
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
  it the views ``qw[idx]``/``scale[idx]``, which copy nothing. Under
  ``config.act_quant`` (w8a8) a per-channel INT8 linear quantizes its
  activations per row: ``qmm``'s s8 x s8 body up to 64 rows, the plain
  ``w8a8_matmul`` above, in prefill, decode and the lm_head alike.
- ``ZG2_WMM=1`` sends the float block linears of ``decode_step`` (up to
  ``_qmm_cap`` rows) through the float GEMV kernel ``wmm``, as the JAX
  package's ``_gemv_dispatch`` does; prefill and the tied lm_head stay
  ``torch.matmul``. Off by default, as in the JAX package.
- ``extend`` runs a (B, T) token window at each lane's ``length`` and
  returns logits at every window position (the speculative verify and
  draft catch-up, and the suffix of a prefix-cache hit): the window's K/V
  are appended first (packed, then quantized, for a packed INT8 cache),
  then attended in plain torch ops over unpacked views of the cache
  (``ops.extend_attention[_quant]``; the JAX package runs no kernel there
  either). Its linears take the decode routing at B * T rows: ``qmm`` up
  to ``_qmm_cap`` rows, ``wmm`` under ``ZG2_WMM=1``, the plain product
  above.
- The lm_head is tied to wte unless ``params["lm_head"]`` exists (the
  quantized tree unties it), and runs only on the positions that need
  logits; padded vocab rows are masked.
- ``ZG2_FUSE_QKV=1`` (off by default, as in the JAX package) serves one
  fused ``wqkv`` projection per layer (``fuse_qkv_params``: Q, K and V
  concatenated on N, float or quantized) instead of three: one GEMV
  launch where there were three. ``prepare_serving`` applies it after
  the phantom head is padded in, so each third of ``wqkv`` is
  ``attn_heads * head_dim`` wide and ``_qkv`` splits at equal thirds.
- ``forward`` follows the caller's grad mode (training differentiates
  it; the serving and eval callers run it under ``torch.no_grad`` or
  ``torch.inference_mode``); ``remat=True`` recomputes each block's
  activations in the backward pass (``torch.utils.checkpoint``).
  ``prefill``, ``decode_step`` and ``extend`` build no autograd graph. On
  a card, the single-device batcher replays its plain ``decode_step`` from
  one captured CUDA graph (``runtime.decode_graph``).
- Tensor parallelism (a rank's config from ``parallel.mesh.local_config``,
  which carries ``model_group``): the same code runs on the rank's shards
  (H/tp heads, the column linears' N/tp, the row linears' K/tp, V/tp vocab
  rows) with three collective sites, the JAX package's step-level ones:
  the vocab-parallel embedding (a masked local lookup, then an all-reduce),
  each row-parallel c_proj (``_row_linear``: the f32 product all-reduced,
  then cast to x's dtype, then the bias; INT4 all-gathers x and takes the
  rank's two half-split feature ranges), and the lm_head's phantom-vocab
  mask by global id. A w8a8 c_proj quantizes each activation row over the
  rank's K in ``decode_step``, as the JAX step-level body does (or over
  the whole row under ``config.op_level``), and over the whole row in
  ``prefill``, ``extend`` and ``forward``, as its GSPMD programs do. Under
  autograd (``forward``) the input of each column-parallel linear and of
  the lm_head sums its gradient over the model group
  (``Collectives.sum_grad``), Megatron's conjugate of the row-parallel
  all-reduce.
- Sequence parallelism (``config.seq_parallel`` on a rank's config: the
  JAX package's (data, model, None) constraint on the prefill residual
  stream, in Megatron-SP's per-rank form) in ``prefill`` and ``forward``:
  the residual stream and the LayerNorms run on the rank's T/tp rows (T
  padded with zero rows up to a multiple of tp; the length mask already
  hides them); the embedding and each row-parallel c_proj reduce-scatter
  over the sequence instead of all-reducing; each column-parallel linear's
  input is all-gathered over the sequence and cut back to the T rows, so
  every product, the attention and the K/V written to the cache see the
  plain tensor-parallel shapes. At tp=2 the logits and the cache are bit
  for bit the plain tensor-parallel ones (a sum of two is the same either
  way round).
- ``prefill``, ``extend`` and ``decode_step`` each run inside a
  ``model.prefill`` / ``model.extend`` / ``model.decode_step`` span
  (``utils.profiling.span``, with the batch ``B`` and window ``T``; a
  decode step also ``graph``, 0 here and 1 around a CUDA graph's replay),
  kept only while a ``torch.profiler`` session is active.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.ops import layers as ops
from zig_gpt2_tpu_torch.ops.attention import (decode_attention_deferred,
                                              decode_attention_quant_deferred,
                                              pack_heads_rows, pack_heads_seq,
                                              unpack_heads_seq, unpack_pair_scales_seq)
from zig_gpt2_tpu_torch.quant import kernels
from zig_gpt2_tpu_torch.quant.quantize import (is_quantized, pad_linear, quantized_linear,
                                               quantized_product)
from zig_gpt2_tpu_torch.utils.profiling import span

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# KV cache layout
# ---------------------------------------------------------------------------

def default_kv_packed(config: GPTConfig, device, tp: Optional[int] = None) -> bool:
    """Whether a runtime on ``device`` serves the head-pair-packed KV cache:
    the JAX package's rule (``prepare_serving``) where the port's kernels
    run. ``ZG2_KV_PACKED``: ``0`` off; ``1`` on wherever the layout is legal
    (head_dim 64, and under a mesh (``tp``, its model-parallel degree; None
    on one device) an even head count per rank: pairs never straddle ranks,
    and no phantom head is added); ``auto`` (the default) on
    where it is legal and the device is a CUDA card. For an INT8 cache the
    layout changes the results (per-pair scales), so the card serves what
    the JAX package serves on its chip.

    A config that already asks for the packed layout keeps it, and raises
    where the layout cannot run: a head_dim other than 64, or an odd head
    count per rank."""
    local_odd = tp is not None and (config.attn_heads // tp) % 2 == 1
    if config.kv_packed:
        _check_packed(config)
        if local_odd:
            raise ValueError(f"the packed KV layout needs an even head count per rank, not "
                             f"{config.attn_heads} over tp={tp}")
        return True
    opt = os.environ.get("ZG2_KV_PACKED", "auto")
    if opt not in ("0", "1", "auto"):
        raise ValueError(f"ZG2_KV_PACKED={opt!r}: expected 0, 1 or auto")
    if opt == "0" or config.head_dim != 64 or local_odd:
        return False
    return opt == "1" or torch.device(device).type == "cuda"


def _check_packed(config: GPTConfig) -> None:
    if config.head_dim != 64:
        raise ValueError(f"the packed KV layout needs head_dim 64, not {config.head_dim}")


def _packed_rows(config: GPTConfig) -> int:
    """Packed rows per lane: head pairs, the phantom head counted."""
    return (config.attn_heads + 1) // 2


def _check_packed_weights(config: GPTConfig) -> None:
    if config.kv_packed and config.attn_heads % 2:
        raise ValueError(f"the packed layout needs an even head count in the weights, not "
                         f"{config.attn_heads}: add the phantom head with pad_phantom_head")


def pad_phantom_head(params: Params, config: GPTConfig) -> Tuple[Params, GPTConfig]:
    """The packed layout's zero phantom head, put into the weights once: for
    an odd head count (1.5B's 25), a last head of zero Q/K/V columns and
    biases and zero c_proj rows, and ``padded_heads`` one more. Its q, k and
    v are exactly zero, as the JAX package's per-step padding makes them,
    and its output meets zero c_proj rows. Float or quantized linears.
    Returns (params, config) unchanged for an even count."""
    if config.attn_heads % 2 == 0:
        return params, config
    if "wqkv" in params["blocks"]["attn"]:
        raise ValueError("pad the phantom head before fusing Q/K/V (prepare_serving's order)")
    attn = dict(params["blocks"]["attn"])
    for name in ("wq", "wk", "wv"):
        attn[name] = pad_linear(attn[name], n_out=config.head_dim)
    attn["c_proj"] = pad_linear(attn["c_proj"], n_in=config.head_dim)
    params = dict(params, blocks=dict(params["blocks"], attn=attn))
    return params, dataclasses.replace(config, padded_heads=config.attn_heads + 1)


def fuse_qkv_params(params: Params) -> Params:
    """The three attention projections as one stacked ``wqkv`` linear
    (N axis: [Q | K | V]), so a layer runs one (E, 3A) product instead of
    three (E, A) ones. Float (``w``) or quantized (``qw``/``qw4`` and
    ``scale``) leaves, and the biases: the INT4 pack and the scale groups
    lie on K, so an N-axis concat keeps them. Idempotent. A serving-time
    transform (``prepare_serving`` under ``ZG2_FUSE_QKV=1``), never
    written to checkpoints."""
    attn = dict(params["blocks"]["attn"])
    if "wqkv" in attn:
        return params
    parts = [attn.pop(name) for name in ("wq", "wk", "wv")]
    attn["wqkv"] = {key: torch.cat([p[key] for p in parts], dim=-1)
                    for key in parts[0] if key in ("w", "qw", "qw4", "scale", "b")}
    return dict(params, blocks=dict(params["blocks"], attn=attn))


def _fuse_qkv_enabled() -> bool:
    """``ZG2_FUSE_QKV``: ``0``, the default, serves separate Q/K/V
    projections; ``1`` fuses them (``fuse_qkv_params``). Off by default as
    in the JAX package."""
    opt = os.environ.get("ZG2_FUSE_QKV", "0")
    if opt not in ("0", "1"):
        raise ValueError(f"ZG2_FUSE_QKV={opt!r}: expected 0 or 1")
    return opt == "1"


def fuse_qkv_if_enabled(params: Params) -> Params:
    return fuse_qkv_params(params) if _fuse_qkv_enabled() else params


def prepare_serving(params: Params, config: GPTConfig, device) -> Tuple[Params, GPTConfig]:
    """The single-device half of the JAX package's ``prepare_serving``: the
    layout ``default_kv_packed`` decides for ``device`` and, when packed,
    the phantom head in the weights; then, under ``ZG2_FUSE_QKV=1``, the
    fused Q/K/V projection (after the padding, so that each third holds
    the padded heads). Returns (params, config)."""
    config = dataclasses.replace(config, kv_packed=default_kv_packed(config, device))
    if config.kv_packed:
        params, config = pad_phantom_head(params, config)
    return fuse_qkv_if_enabled(params), config


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
    """Preallocate the fixed-shape KV cache: float in ``dtype``, or with
    ``quant="int8"`` int8 rows with f32 scale planes (``dtype`` is then
    unused), per (token, head), or per (token, head pair) in the packed
    layout (``config.kv_packed``: rows (L, B, Hp, S, 2D)). A ring cache
    (``config.ring_cache``, or ``ring`` when given: ``ring=False`` builds
    the linear lane caches that admissions prefill under a ring config)
    adds ``start`` (B,) and ``wptr`` (), int32, zero."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown KV quantization {quant!r}")
    max_seq = max_seq or config.context_size
    if config.kv_packed:
        _check_packed(config)
        shape = (config.n_layers, batch_size, _packed_rows(config), max_seq,
                 2 * config.head_dim)
    else:
        shape = (config.n_layers, batch_size, config.attn_heads, max_seq,
                 config.head_dim)
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

def _use_wmm() -> bool:
    """Whether the float decode linears take the ``wmm`` GEMV kernel
    (``ZG2_WMM``: ``0``, the default, off; ``1`` on: the kernel on a CUDA
    tensor, its plain version on a CPU one). Off by default as in the JAX
    package (``_use_wmm``); whether the card should default to it waits for
    an A/B on the card."""
    opt = os.environ.get("ZG2_WMM", "0")
    if opt not in ("0", "1"):
        raise ValueError(f"ZG2_WMM={opt!r}: expected 0 or 1")
    return opt == "1"


def _qmm_cap(config: GPTConfig, int4: bool) -> int:
    """Row cap of the decode GEMV kernels (the JAX package's ``_qmm_cap``):
    256, or 64 for the w8a8 body under ``act_quant`` (any weight that is not
    INT4, so also the float weights that ``wmm`` takes)."""
    if config.act_quant and not int4:
        return kernels.W8A8_MAX_ROWS
    return kernels.GEMV_MAX_ROWS


def _linear(p: Dict[str, torch.Tensor], x: torch.Tensor, config: GPTConfig,
            wmm: bool = False) -> torch.Tensor:
    """Apply one (already layer-sliced) linear: quantized (w8a8 for a
    per-channel INT8 one under ``config.act_quant``) or float. ``wmm``: a
    decode linear under ``ZG2_WMM=1``, where a float weight takes the
    ``wmm`` GEMV up to ``_qmm_cap`` rows; its f32 result is cast to x's
    dtype before the bias is added."""
    if is_quantized(p):
        return quantized_linear(p, x, act_quant=config.act_quant)
    rows = x.numel() // x.shape[-1]
    if wmm and rows <= _qmm_cap(config, int4=False):
        y = kernels.wmm(x.reshape(rows, x.shape[-1]).contiguous(), p["w"])
        y = y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])
        return y if p.get("b") is None else y + p["b"]
    return ops.linear(x, p["w"], p.get("b"))


def _seq_parallel(config: GPTConfig) -> bool:
    """Whether ``prefill``/``forward`` run sequence-parallel: a rank's config
    with ``seq_parallel`` over more than one model rank."""
    group = config.model_group
    return config.seq_parallel and group is not None and group.size > 1


def _seq_pad(t: torch.Tensor, tp: int, value: float = 0.0) -> torch.Tensor:
    """(B, T, ...) -> (B, Tp, ...): T padded with ``value`` rows up to a
    multiple of tp."""
    extra = -t.shape[1] % tp
    if not extra:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, extra), value=value)


def _seq_slice(t: torch.Tensor, group, value: float = 0.0) -> torch.Tensor:
    """This rank's rows of a (B, T, ...) tensor that every rank holds whole,
    T padded first (``_seq_pad``)."""
    t = _seq_pad(t, group.size, value)
    n = t.shape[1] // group.size
    return t[:, group.index * n:(group.index + 1) * n]


def _col_in(h: torch.Tensor, config: GPTConfig, T: int) -> torch.Tensor:
    """The input of a column-parallel linear (or the lm_head) in ``prefill``
    and ``forward``. Under tensor parallelism its gradient is summed over
    the model group; under sequence parallelism the rank's rows are
    all-gathered over the sequence (the gradient reduce-scattered) and cut
    back to the true T rows."""
    group = config.model_group
    if group is None:
        return h
    if not _seq_parallel(config):
        return group.sum_grad(h)
    h = group.gather_seq(h, 1)
    return h if h.shape[1] == T else h[:, :T].contiguous()


def _row_linear(p: Dict[str, torch.Tensor], x: torch.Tensor, config: GPTConfig,
                wmm: bool = False, full_row_scale: bool = True,
                scatter: bool = False) -> torch.Tensor:
    """A row-parallel linear (the c_proj pair): ``_linear`` on one device.
    Under tensor parallelism x is this rank's K slice (the output of the
    column-parallel linear before it) and the weight holds the matching K
    rows: the product in f32 (no bias), all-reduced over the model group,
    then cast to x's dtype, then the replicated bias. An INT4 weight's rows
    hold two half-split feature ranges, so x is all-gathered and those
    cut out (``int4_row_shard_slices``). A w8a8 weight quantizes each x row
    over its whole K when ``full_row_scale`` (``w8a8_row_full_partial``:
    the exact integer sums are reduced, then scaled), else over the rank's
    K. A float 16-bit product is rounded to its dtype once before the sum.
    ``scatter`` (sequence parallelism, x (B, T, K)): the sum is
    reduce-scattered over the sequence instead, and the result is this
    rank's (B, Tp / tp, N) rows."""
    group = config.model_group
    if group is None:
        return _linear(p, x, config, wmm)
    from zig_gpt2_tpu_torch.parallel import shard_kernels

    *lead, k_local = x.shape
    x2 = x.reshape(-1, k_local)
    sx = None
    w8a8 = config.act_quant and "qw" in p and p["scale"].shape[-2] == 1
    if w8a8 and full_row_scale:  # the exact integer sums are reduced
        y, sx = shard_kernels.w8a8_row_full_partial(x2, p["qw"], group)
    elif is_quantized(p):
        q = p
        if "qw4" in p:
            x2, scale = shard_kernels.int4_row_shard_slices(
                group.all_gather_cat(x2, dim=1), p["scale"], group.size, group.index)
            q = {"qw4": p["qw4"], "scale": scale}
        y = quantized_product(q, x2, config.act_quant).float()
    elif wmm and x2.shape[0] <= _qmm_cap(config, int4=False):
        y = kernels.wmm(x2.contiguous(), p["w"])
    else:
        y = torch.matmul(x2, p["w"]).float()
    if scatter:
        y = group.reduce_scatter(_seq_pad(y.reshape(*lead, -1), group.size), 1)
        lead = y.shape[:-1]
        y = y.reshape(-1, y.shape[-1])
        if sx is not None:
            sx = _seq_slice(sx.reshape(lead[0], -1), group, 1.0).reshape(-1)
    else:
        y = group.all_reduce(y)
    if sx is not None:
        y = kernels.w8a8_tail(y, sx, p["scale"])
    y = y.to(x.dtype).reshape(*lead, y.shape[-1])
    return y if p.get("b") is None else y + p["b"]


def _layer(tree: Params, idx: int) -> Params:
    """Views of every (L, ...) leaf of a stacked subtree at layer idx."""
    return {k: _layer(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def _qkv(attn_p: Params, h: torch.Tensor, config: GPTConfig, wmm: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., E) -> three (..., H, D) projections: three linears, or the
    fused ``wqkv`` one split at equal thirds (views of its output)."""
    n_heads = config.attn_heads

    def heads(t):
        return t.reshape(*t.shape[:-1], n_heads, t.shape[-1] // n_heads)

    if "wqkv" in attn_p:
        return tuple(heads(t) for t in _linear(attn_p["wqkv"], h, config, wmm).chunk(3, -1))
    return tuple(heads(_linear(attn_p[name], h, config, wmm)) for name in ("wq", "wk", "wv"))


def _block_prefill(x: torch.Tensor, bp: Params, config: GPTConfig,
                   length_mask: Optional[torch.Tensor], T: int):
    """One block over a full sequence of T positions: returns (x, k, v), k/v
    (B, H, T, D). Under sequence parallelism x is the rank's (B, Tp / tp,
    E) rows of the residual stream (``_seq_parallel``)."""
    sp = _seq_parallel(config)
    h = ops.layer_norm(x, bp["ln_1"]["w"], bp["ln_1"]["b"], config.layer_norm_eps)
    h = _col_in(h, config, T)
    B = h.shape[0]
    q, k, v = (t.transpose(1, 2) for t in _qkv(bp["attn"], h, config))
    attn = ops.causal_attention(q, k, v, length_mask=length_mask)
    attn = attn.transpose(1, 2).reshape(B, T, -1)
    x = x + _row_linear(bp["attn"]["c_proj"], attn, config, scatter=sp)
    h = ops.layer_norm(x, bp["ln_2"]["w"], bp["ln_2"]["b"], config.layer_norm_eps)
    h = ops.gelu(_linear(bp["mlp"]["c_fc"], _col_in(h, config, T), config))
    x = x + _row_linear(bp["mlp"]["c_proj"], h, config, scatter=sp)
    return x, k, v


def _put_row_stacked(stack: torch.Tensor, row: torch.Tensor, idx: int,
                     pos: torch.Tensor) -> None:
    """Write (B, H, D) rows into the stacked (L, B, H, S, D) cache at
    (idx, b, :, pos[b], :), or (B, H) scales into a stacked (L, B, H, S)
    plane at (idx, b, :, pos[b]), in place, with one indexed write (H and D
    are Hp and 2D in the packed layout: only the S axis is named). A 0-d
    ``pos`` (the ring's shared write row) puts every lane's row at that one
    row with one ``index_copy_``, the index staying on the device."""
    if pos.dim() == 0:
        stack[idx].index_copy_(2, pos.view(1).long(), row.unsqueeze(2).to(stack.dtype))
        return
    lanes = torch.arange(row.shape[0], device=stack.device)
    stack[idx, lanes, :, pos.long()] = row.to(stack.dtype)


def _block_decode(x: torch.Tensor, blocks: Params, idx: int, caches: KVCache,
                  pos: torch.Tensor, start: Optional[torch.Tensor],
                  wpos: torch.Tensor, config: GPTConfig, wmm: bool = False) -> torch.Tensor:
    """One block for one decode token per lane. ``pos`` (B,) is each lane's
    count of valid cache rows: the prefix [0, pos), or with ``start`` the
    ring interval. ``wpos`` is the row this token's K/V is written to, per
    lane (B,) or shared (). Attends first (deferred), then appends in
    place. ``wmm``: float linears take the wmm GEMV (``_use_wmm``)."""
    bp = _layer(blocks, idx)
    h = ops.layer_norm(x, bp["ln_1"]["w"], bp["ln_1"]["b"], config.layer_norm_eps)
    # (B, H, D), contiguous for the kernels (a fused projection's thirds
    # are strided views when B > 1)
    q, k, v = (t.contiguous() for t in _qkv(bp["attn"], h, config, wmm))
    packed = config.kv_packed
    if packed:  # (B, Hp, 2D) views, before any quantization: a scale per pair
        q, k, v = (pack_heads_rows(t) for t in (q, k, v))
    if "k_scale" in caches:  # INT8 cache: quantize, attend, then append
        (kq, ks), (vq, vs) = ops.quantize_kv(k), ops.quantize_kv(v)
        attn = decode_attention_quant_deferred(
            q, kq, ks, vq, vs, caches["k"], caches["k_scale"], caches["v"],
            caches["v_scale"], pos, layer=idx, start=start, packed=packed)
        for name, row in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
            _put_row_stacked(caches[name], row, idx, wpos)
    else:
        attn = decode_attention_deferred(q, k, v, caches["k"], caches["v"], pos,
                                         layer=idx, start=start, packed=packed)
        _put_row_stacked(caches["k"], k, idx, wpos)
        _put_row_stacked(caches["v"], v, idx, wpos)
    x = x + _row_linear(bp["attn"]["c_proj"], attn.reshape(x.shape[0], -1), config, wmm,
                        full_row_scale=config.op_level)
    h = ops.layer_norm(x, bp["ln_2"]["w"], bp["ln_2"]["b"], config.layer_norm_eps)
    h = ops.gelu(_linear(bp["mlp"]["c_fc"], h, config, wmm))
    return x + _row_linear(bp["mlp"]["c_proj"], h, config, wmm,
                           full_row_scale=config.op_level)


def _lm_head(params: Params, x: torch.Tensor, config: GPTConfig) -> torch.Tensor:
    """logits = x @ wte^T, or ``params["lm_head"]`` (untied, quantized by
    ``quantize_params``; w8a8 under ``config.act_quant``) when present;
    padded vocab rows are masked (under tensor parallelism the logits are
    the rank's vocab slice: its ids are offset to global ones first)."""
    if "lm_head" in params:
        logits = _linear(params["lm_head"], x, config)
    else:
        logits = torch.matmul(x, params["wte"].T)
    if config.padded_vocab_size is not None:
        vl = logits.shape[-1]
        first = config.model_group.index * vl if config.model_group is not None else 0
        ids = torch.arange(first, first + vl, device=logits.device)
        logits = logits.masked_fill(ids >= config.vocab_size, ops.MASK_VALUE)
    return logits


def _embed(params: Params, tokens: torch.Tensor, pos: torch.Tensor,
           config: GPTConfig, scatter: bool = False) -> torch.Tensor:
    """Token plus position embeddings. Under tensor parallelism wte is the
    rank's vocab rows: a masked local lookup (zero for ids outside them),
    all-reduced over the model group (the vocab-parallel embedding); with
    ``scatter`` (sequence parallelism: tokens (B, T), pos (T,))
    reduce-scattered over the sequence instead, plus the rank's rows of the
    position embeddings."""
    wte, group = params["wte"], config.model_group
    if group is None:
        tok = ops.embedding(tokens.long(), wte)
        return tok + ops.embedding(pos.long(), params["wpe"])
    vl = wte.shape[0]
    local = tokens.long() - group.index * vl
    ok = (local >= 0) & (local < vl)
    tok = ops.embedding(local.clamp(0, vl - 1), wte)
    tok = torch.where(ok[..., None], tok, torch.zeros((), dtype=tok.dtype, device=tok.device))
    if not scatter:
        return group.all_reduce(tok) + ops.embedding(pos.long(), params["wpe"])
    pos = _seq_slice(pos.expand(tokens.shape)[..., None], group)[..., 0]  # padding: row 0
    return (group.reduce_scatter(_seq_pad(tok, group.size), 1)
            + ops.embedding(pos.long(), params["wpe"]))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _block_forward(x: torch.Tensor, bp: Params, config: GPTConfig, T: int) -> torch.Tensor:
    return _block_prefill(x, bp, config, None, T)[0]


def forward(params: Params, tokens: torch.Tensor, config: GPTConfig,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward: (B, T) tokens -> (B, T, vocab) logits, for
    perplexity and training; it differentiates when grad is enabled.
    ``remat``: under grad, checkpoint each block (its activations are
    recomputed in the backward pass instead of kept: activation memory for
    compute, as the JAX package's ``jax.checkpoint``). Under tensor
    parallelism the logits are the rank's vocab slice."""
    T = tokens.shape[1]
    x = _embed(params, tokens, torch.arange(T, device=tokens.device), config,
               _seq_parallel(config))
    recompute = remat and torch.is_grad_enabled()
    for idx in range(config.n_layers):
        bp = _layer(params["blocks"], idx)
        if recompute:
            x = torch.utils.checkpoint.checkpoint(_block_forward, x, bp, config, T,
                                                  use_reentrant=False)
        else:
            x = _block_forward(x, bp, config, T)
    x = ops.layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"], config.layer_norm_eps)
    return _lm_head(params, _col_in(x, config, T), config)


@torch.no_grad()
def prefill(params: Params, cache: KVCache, tokens: torch.Tensor,
            lengths: torch.Tensor, config: GPTConfig) -> Tuple[KVCache, torch.Tensor]:
    """Run a right-padded (B, T) prompt batch with true ``lengths`` (B,)
    through the model, writing rows [0, T) of every layer's cache in place
    (rows at or past a lane's length are padding that no read reaches and
    the next decode steps overwrite). Returns (cache, (B, vocab) logits at
    each lane's last prompt position)."""
    _check_packed_weights(config)
    B, T = tokens.shape
    with span("model.prefill", B=B, T=T):
        pos = torch.arange(T, device=tokens.device)
        x = _embed(params, tokens, pos, config, _seq_parallel(config))
        lengths = lengths.to(device=tokens.device, dtype=torch.int32)
        length_mask = pos[None, :] < lengths[:, None]
        for idx in range(config.n_layers):
            x, k, v = _block_prefill(x, _layer(params["blocks"], idx), config, length_mask, T)
            if config.kv_packed:  # pack, and only then quantize (per pair)
                k, v = pack_heads_seq(k), pack_heads_seq(v)
            if "k_scale" in cache:  # INT8 cache: quantize on append
                (k, ks), (v, vs) = ops.quantize_kv(k), ops.quantize_kv(v)
                cache["k_scale"][idx, :, :, :T] = ks
                cache["v_scale"][idx, :, :, :T] = vs
            cache["k"][idx, :, :, :T] = k.to(cache["k"].dtype)
            cache["v"][idx, :, :, :T] = v.to(cache["v"].dtype)
        x = ops.layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"], config.layer_norm_eps)
        x = _col_in(x, config, T)
        last = x[torch.arange(B, device=x.device), lengths.long() - 1]
        cache["length"] = lengths.clone()
        return cache, _lm_head(params, last, config)


@torch.no_grad()
def decode_step(params: Params, cache: KVCache, tokens: torch.Tensor,
                config: GPTConfig) -> Tuple[KVCache, torch.Tensor]:
    """One autoregressive step: (B,) tokens -> (cache, (B, vocab) logits).
    The cache is updated in place (see the module docstring), ``length``
    and ``wptr`` among it: the dict keeps the same tensors, so a CUDA graph
    captured over a step (``runtime.decode_graph``) replays into them.

    A lane may run past its window while idle (the batcher keeps decoding
    a retired slot and discards its tokens); its position embedding index
    clamps at the table's last row and, in a linear cache, its write row at
    the cache's last row, as the JAX package's dynamic_update_slice
    clamps. Under the ring the length clamps at rows - 1, so an interval
    never reaches the write row, and ``wptr`` advances by one."""
    _check_packed_weights(config)
    with span("model.decode_step", B=tokens.shape[0], T=1, graph=0):
        pos = cache["length"]
        rows = cache["k"].shape[-2]
        x = _embed(params, tokens, pos.clamp(max=params["wpe"].shape[0] - 1), config)
        if config.ring_cache:
            start, wpos = cache["start"], cache["wptr"]
        else:
            start, wpos = None, pos.clamp(max=rows - 1)
        wmm = _use_wmm()
        for idx in range(config.n_layers):
            x = _block_decode(x, params["blocks"], idx, cache, pos, start, wpos, config, wmm)
        x = ops.layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"], config.layer_norm_eps)
        if config.ring_cache:
            cache["wptr"].copy_((wpos + 1) % rows)
            pos.copy_((pos + 1).clamp(max=rows - 1))
        else:
            pos.copy_(pos + 1)
        return cache, _lm_head(params, x, config)


def _put_window(stack: torch.Tensor, win: torch.Tensor, idx: int, rows: torch.Tensor) -> None:
    """Write a (B, T, H[, D]) window into the stacked (L, B, H, S[, D]) cache
    (or (L, B, H, S) scale plane) at (idx, b, :, rows[b, t]), in place, with
    one indexed write (H and D are Hp and 2D in the packed layout)."""
    lanes = torch.arange(win.shape[0], device=stack.device)[:, None]
    stack[idx][lanes, :, rows] = win.to(stack.dtype)


def _block_extend(x: torch.Tensor, blocks: Params, idx: int, caches: KVCache,
                  base: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor,
                  config: GPTConfig, wmm: bool = False) -> torch.Tensor:
    """One block over a (B, T) window whose K/V land at cache rows ``rows``
    (B, T) of each lane: append, then attend over the cache's first
    base + t + 1 rows (``ops.extend_attention[_quant]``) through unpacked
    views of a packed cache."""
    bp = _layer(blocks, idx)
    B, T, _ = x.shape
    h = ops.layer_norm(x, bp["ln_1"]["w"], bp["ln_1"]["b"], config.layer_norm_eps)
    q, k, v = _qkv(bp["attn"], h, config, wmm)  # (B, T, H, D)
    packed = config.kv_packed
    if packed:  # pack the window before any quantization: a scale per pair
        k, v = pack_heads_rows(k), pack_heads_rows(v)

    def cache_at(name):
        c = caches[name][idx]
        if not packed:
            return c
        return unpack_pair_scales_seq(c) if name.endswith("_scale") else unpack_heads_seq(c)

    q = q.transpose(1, 2)  # (B, H, T, D)
    if "k_scale" in caches:  # INT8 cache: quantize the window on append
        (kq, ks), (vq, vs) = ops.quantize_kv(k), ops.quantize_kv(v)
        for name, win in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
            _put_window(caches[name], win, idx, rows)
        attn = ops.extend_attention_quant(q, cache_at("k"), cache_at("k_scale"), cache_at("v"),
                                          cache_at("v_scale"), base, valid)
    else:
        _put_window(caches["k"], k, idx, rows)
        _put_window(caches["v"], v, idx, rows)
        attn = ops.extend_attention(q, cache_at("k"), cache_at("v"), base, valid)
    attn = attn.transpose(1, 2).reshape(B, T, -1)
    x = x + _row_linear(bp["attn"]["c_proj"], attn, config, wmm)
    h = ops.layer_norm(x, bp["ln_2"]["w"], bp["ln_2"]["b"], config.layer_norm_eps)
    h = ops.gelu(_linear(bp["mlp"]["c_fc"], h, config, wmm))
    return x + _row_linear(bp["mlp"]["c_proj"], h, config, wmm)


@torch.no_grad()
def extend(params: Params, cache: KVCache, tokens: torch.Tensor, valid: torch.Tensor,
           config: GPTConfig) -> Tuple[KVCache, torch.Tensor]:
    """Multi-token forward from each lane's ``cache["length"]``: a (B, T)
    window right-padded per lane, ``valid`` (B,) true rows (1 <= valid <=
    T). Returns (cache, (B, T, vocab) logits), row t the next-token
    logits after tokens[:, :t + 1]; rows at or past ``valid`` are garbage.
    Padding rows are appended too, but ``length`` advances by ``valid``
    only, so later appends overwrite them. The cache is updated in place.

    The caller keeps T rows of headroom past every lane's length. Past
    that, the window's first row clamps to S - T, as the JAX package's
    dynamic_update_slice clamps: a lane that runs past (an idle batcher
    lane) writes back over its own last rows. Positions clamp into wpe.
    A linear cache only (a ring config's linear lane caches too): no caller
    extends a ring."""
    if "wptr" in cache:
        raise ValueError("extend takes a linear KV cache, not a ring")
    _check_packed_weights(config)
    base = cache["length"]
    B, T = tokens.shape
    with span("model.extend", B=B, T=T):
        S = cache["k"].shape[-2]
        steps = torch.arange(T, device=tokens.device)
        pos = (base[:, None] + steps[None, :]).clamp(max=params["wpe"].shape[0] - 1)
        x = _embed(params, tokens, pos, config)
        valid = valid.to(device=tokens.device, dtype=torch.int32)
        rows = (base.clamp(max=S - T)[:, None] + steps[None, :]).long()
        wmm = _use_wmm()
        for idx in range(config.n_layers):
            x = _block_extend(x, params["blocks"], idx, cache, base, valid, rows, config, wmm)
        x = ops.layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"], config.layer_norm_eps)
        cache["length"] = base + valid
        return cache, _lm_head(params, x, config)
