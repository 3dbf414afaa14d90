"""Deferred-append decode attention: the CUDA kernel's wrappers and their
plain PyTorch versions.

Counterparts of ``zig_gpt2_tpu.ops.attention.decode_attention_deferred_fused``
(float cache) and ``decode_attention_quant_deferred_fused`` (INT8 cache),
unpacked layout, with the prefix mask or, given ``start``, the ring
interval. The kernel is ``csrc/decode_attention.cu``, one body with the
cache type and the ring as template parameters. A CUDA tensor launches it
(or the wrapper raises); a CPU tensor runs the plain version. Each wrapper
counts its launches in ``launches`` (prefix) and ``ring_launches`` (ring).

The INT8 variant follows the TPU kernel's all-f32 arithmetic, not the JAX
package's jnp reference ``ops.layers.decode_attention_quant``, which rounds
q and p * v_scale to bf16.
"""

from __future__ import annotations

import math

import torch

from zig_gpt2_tpu_torch.ops import _build
from zig_gpt2_tpu_torch.ops.layers import decode_valid_mask

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _softmax_with_self_term(s_self, scores, v_self, v, valid):
    """Softmax over {s_self} U {scores[s] : valid[s]} applied to
    {v_self} U {v[s]}, in f32. s_self (B, H, 1), scores (B, H, S), v_self
    (B, H, D), v (B, H, S, D) already weighted (rows past length may hold
    anything: they are masked out of both sums)."""
    scores = scores.masked_fill(~valid, -math.inf)
    m = torch.maximum(s_self, scores.amax(-1, keepdim=True))
    p_self = torch.exp(s_self - m)
    p = torch.exp(scores - m)  # exactly 0 where masked
    den = p_self + p.sum(-1, keepdim=True)
    v = v.masked_fill(~valid[..., None], 0.0)
    return (p_self * v_self + torch.einsum("bhs,bhsd->bhd", p, v)) / den


def _valid(length, rows, device, start):
    """(B, 1, S) bool: each lane's old rows, the prefix [0, length[b]) or,
    with ``start``, the ring interval [start[b], start[b] + length[b]) mod S."""
    return decode_valid_mask(rows, length.to(device),
                             None if start is None else start.to(device))


def decode_attention_deferred_plain(q, k_new, v_new, k_cache, v_cache, length,
                                    *, layer, start=None):
    """The reference's math in plain PyTorch: the self-term seeds the
    softmax over the ``length`` OLD rows of layer ``layer``, all in f32.
    The old rows are the prefix, or with ``start`` the ring interval; the
    other rows are masked out of both sums (they hold stale data, or
    nothing yet)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    k = k_cache[layer].float()  # (B, H, S, D)
    s_self = (qf * k_new.float()).sum(-1, keepdim=True) * scale  # (B, H, 1)
    scores = torch.einsum("bhd,bhsd->bhs", qf, k) * scale
    out = _softmax_with_self_term(s_self, scores, v_new.float(),
                                  v_cache[layer].float(),
                                  _valid(length, k.shape[-2], q.device, start))
    return out.to(q.dtype)


def decode_attention_quant_deferred_plain(q, k_new, ks_new, v_new, vs_new,
                                          k_cache, k_scale, v_cache, v_scale,
                                          length, *, layer, start=None):
    """The INT8 kernel's math in plain PyTorch, all in f32: a row's score is
    (q . k[s]) * scale * k_scale[s], and v_scale[s] weights v[s] only, never
    the denominator. The self-term is (k_new, ks_new, v_new, vs_new); the
    old rows are the prefix, or with ``start`` the ring interval."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    k = k_cache[layer].float()  # (B, H, S, D)
    valid = _valid(length, k.shape[-2], q.device, start)
    s_self = ((qf * k_new.float()).sum(-1, keepdim=True) * scale
              * ks_new.float()[..., None])
    scores = torch.einsum("bhd,bhsd->bhs", qf, k) * scale * k_scale[layer].float()
    # Scale planes outside the valid rows may hold anything (NaN included): zero them
    # before they weight V, since 0 * NaN is NaN.
    vs = v_scale[layer].float().masked_fill(~valid, 0.0)
    v = v_cache[layer].float() * vs[..., None]
    out = _softmax_with_self_term(s_self, scores, v_new.float() * vs_new.float()[..., None],
                                  v, valid)
    return out.to(q.dtype)


def _check(q, tensors, length, start, layer, L):
    """Shape, device and contiguity checks shared by both wrappers:
    ``tensors`` is [(name, tensor, expected shape, expected dtype)];
    ``length`` and a given ``start`` must be (B,) int32."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32 or bfloat16)")
    lanes = [("length", length, (q.shape[0],), torch.int32)]
    if start is not None:
        lanes.append(("start", start, (q.shape[0],), torch.int32))
    for name, t, shape, dtype in tensors + lanes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    D = q.shape[-1]
    if D % 32 or not 32 <= D <= 128:
        raise ValueError(f"head_dim {D} unsupported (32, 64, 96 or 128)")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")


def decode_attention_deferred(q, k_new, v_new, k_cache, v_cache, length, *,
                              layer, start=None):
    """Attend over ``length`` old cache rows of layer ``layer`` plus the
    un-appended current row (k_new, v_new); identical in value to
    append-then-attend over length + 1 rows.

    q, k_new, v_new: (B, H, D); k_cache, v_cache: (L, B, H, S, D); all five
    float32, or all bfloat16; length: (B,) int32; layer: int; start: None
    for the prefix rows [0, length), or (B,) int32 for the ring interval
    [start, start + length) mod S. Returns (B, H, D) in q's dtype. The
    kernel never reads the row that the caller appends next."""
    if q.device.type == "cpu":
        return decode_attention_deferred_plain(q, k_new, v_new, k_cache, v_cache,
                                               length, layer=layer, start=start)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_deferred: no kernel for {q.device}")
    L, B, H, S, D = k_cache.shape
    row, cache = ((B, H, D), q.dtype), ((L, B, H, S, D), q.dtype)
    _check(q, [("q", q, *row), ("k_new", k_new, *row), ("v_new", v_new, *row),
               ("k_cache", k_cache, *cache), ("v_cache", v_cache, *cache)],
           length, start, layer, L)
    out = torch.empty_like(q)
    lib = _build.library()
    ptrs = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), length.data_ptr())
    tail = (out.data_ptr(), B, H, S, D, int(layer), 1.0 / math.sqrt(D),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if start is None:
        _build.check(lib.zg2_decode_attention_deferred(*ptrs, *tail),
                     "decode_attention_deferred")
        decode_attention_deferred.launches += 1
    else:
        _build.check(lib.zg2_decode_attention_deferred_ring(*ptrs, start.data_ptr(),
                                                            *tail),
                     "decode_attention_deferred (ring)")
        decode_attention_deferred.ring_launches += 1
    return out


decode_attention_deferred.launches = 0
decode_attention_deferred.ring_launches = 0


def decode_attention_quant_deferred(q, k_new, ks_new, v_new, vs_new, k_cache,
                                    k_scale, v_cache, v_scale, length, *, layer,
                                    start=None):
    """``decode_attention_deferred`` over an INT8 cache.

    q: (B, H, D) float32 or bfloat16; k_new, v_new: (B, H, D) int8, the
    already-quantized rows that the caller appends next, with (B, H) f32
    scales ks_new, vs_new; k_cache, v_cache: (L, B, H, S, D) int8 with f32
    scale planes k_scale, v_scale (L, B, H, S); length: (B,) int32; start:
    None (prefix) or (B,) int32 (ring interval, planes read at the same
    rows). Returns (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_quant_deferred_plain(
            q, k_new, ks_new, v_new, vs_new, k_cache, k_scale, v_cache, v_scale,
            length, layer=layer, start=start)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant_deferred: no kernel for {q.device}")
    L, B, H, S, D = k_cache.shape
    i8, f32 = torch.int8, torch.float32
    _check(q, [("q", q, (B, H, D), q.dtype),
               ("k_new", k_new, (B, H, D), i8), ("ks_new", ks_new, (B, H), f32),
               ("v_new", v_new, (B, H, D), i8), ("vs_new", vs_new, (B, H), f32),
               ("k_cache", k_cache, (L, B, H, S, D), i8),
               ("k_scale", k_scale, (L, B, H, S), f32),
               ("v_cache", v_cache, (L, B, H, S, D), i8),
               ("v_scale", v_scale, (L, B, H, S), f32)],
           length, start, layer, L)
    out = torch.empty_like(q)
    lib = _build.library()
    ptrs = (q.data_ptr(), k_new.data_ptr(), ks_new.data_ptr(), v_new.data_ptr(),
            vs_new.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(),
            v_cache.data_ptr(), v_scale.data_ptr(), length.data_ptr())
    tail = (out.data_ptr(), B, H, S, D, int(layer), 1.0 / math.sqrt(D),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if start is None:
        _build.check(lib.zg2_decode_attention_quant_deferred(*ptrs, *tail),
                     "decode_attention_quant_deferred")
        decode_attention_quant_deferred.launches += 1
    else:
        _build.check(lib.zg2_decode_attention_quant_deferred_ring(
            *ptrs, start.data_ptr(), *tail), "decode_attention_quant_deferred (ring)")
        decode_attention_quant_deferred.ring_launches += 1
    return out


decode_attention_quant_deferred.launches = 0
decode_attention_quant_deferred.ring_launches = 0
