"""Single-query decode attention: the CUDA kernel's wrappers, their plain
PyTorch versions and the head-pair layout helpers.

Counterparts of ``zig_gpt2_tpu.ops.attention``:
``decode_attention_deferred_fused`` (float cache) and
``decode_attention_quant_deferred_fused`` (INT8 cache), the deferred forms
that the model runs, and ``decode_attention_fused`` and
``decode_attention_quant_fused``, the appended forms (no self-term), which
no serving path of either package runs. Each takes the prefix mask or,
given ``start``, the ring interval, and the unpacked layout or, with
``packed=True``, the head-pair-packed one. The kernel is
``csrc/decode_attention.cu``, one body with the cache type, the ring, the
layout and the self-term as template parameters, launched once per call
over (splits, H, B) blocks (``attention_splits``: the cache rows split
into chunks, merged in split order by the last block). A CUDA tensor
launches it (or the wrapper raises); a CPU tensor runs the plain version.
Each wrapper counts its launches per variant: ``launches`` (prefix),
``ring_launches``, ``packed_launches`` and ``packed_ring_launches``, and
in ``by_dtype`` per (variant, q's dtype, the cache's dtype).

Packed layout (head_dim 64): adjacent heads (2p, 2p + 1) share one 2D-wide
row, lanes [0, D) and [D, 2D); rows are (..., Hp, 2D) and caches
(L, B, Hp, S, 2D). An INT8 cache quantizes the packed rows, so its scales
are per pair: new-row scales (B, Hp) and planes (L, B, Hp, S).

The INT8 variants follow the TPU kernel's all-f32 arithmetic, not the JAX
package's jnp reference ``ops.layers.decode_attention_quant``, which rounds
q and p * v_scale to bf16.
"""

from __future__ import annotations

import math

import torch

from zig_gpt2_tpu_torch.ops import _build, tallies
from zig_gpt2_tpu_torch.ops.layers import decode_valid_mask

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --- head-pair layout helpers ----------------------------------------------

def pack_heads_rows(x: torch.Tensor) -> torch.Tensor:
    """(..., H, D) -> (..., H/2, 2D): a view, adjacent heads are contiguous."""
    *lead, h, d = x.shape
    return x.reshape(*lead, h // 2, 2 * d)


def unpack_heads_rows(x: torch.Tensor) -> torch.Tensor:
    """(..., Hp, 2D) -> (..., 2Hp, D), the inverse of ``pack_heads_rows``."""
    *lead, hp, d2 = x.shape
    return x.reshape(*lead, hp * 2, d2 // 2)


def pack_heads_seq(x: torch.Tensor) -> torch.Tensor:
    """(..., H, T, D) -> (..., H/2, T, 2D): prefill K/V into the packed cache
    (a transpose, so a copy)."""
    *lead, h, t, d = x.shape
    x = x.reshape(*lead, h // 2, 2, t, d)
    return x.transpose(-3, -2).reshape(*lead, h // 2, t, 2 * d)


def unpack_heads_seq(x: torch.Tensor) -> torch.Tensor:
    """(..., Hp, S, 2D) -> (..., 2Hp, S, D), the inverse of ``pack_heads_seq``."""
    *lead, hp, s, d2 = x.shape
    x = x.reshape(*lead, hp, s, 2, d2 // 2)
    return x.transpose(-3, -2).reshape(*lead, hp * 2, s, d2 // 2)


def unpack_pair_scales_seq(s: torch.Tensor) -> torch.Tensor:
    """(..., Hp, S) per-pair scale plane -> (..., 2Hp, S) per-head view:
    both heads of a pair share the pair's scale. (An expand, not
    ``repeat_interleave``, so that no size is read back from the card.)"""
    *lead, hp, n = s.shape
    return s.unsqueeze(-2).expand(*lead, hp, 2, n).reshape(*lead, 2 * hp, n)


def unpack_pair_scales_rows(s: torch.Tensor) -> torch.Tensor:
    """(..., Hp) per-pair scale rows -> (..., 2Hp) per-head view."""
    *lead, hp = s.shape
    return s.unsqueeze(-1).expand(*lead, hp, 2).reshape(*lead, 2 * hp)


# --- plain versions ----------------------------------------------------------

def _softmax(scores, v, valid, s_self=None, v_self=None):
    """Softmax over {s_self} U {scores[s] : valid[s]} applied to {v_self} U
    {v[s]}, in f32; without a self-term over the valid rows alone. scores
    (B, H, S), v (B, H, S, D) already weighted, s_self (B, H, 1), v_self
    (B, H, D). Rows past length may hold anything: they are masked out of
    both sums."""
    scores = scores.masked_fill(~valid, -math.inf)
    m = scores.amax(-1, keepdim=True)
    if s_self is not None:
        m = torch.maximum(s_self, m)
    p = torch.exp(scores - m)  # exactly 0 where masked
    den = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhs,bhsd->bhd", p, v.masked_fill(~valid[..., None], 0.0))
    if s_self is not None:
        p_self = torch.exp(s_self - m)
        den = p_self + den
        acc = p_self * v_self + acc
    return acc / den


def _plain(q, new, k, ks, v, vs, length, start, packed):
    """The kernel's math in plain PyTorch, all in f32, over ONE layer's
    cache k, v (B, H, S, D) with per-row scales ks, vs (B, H, S) for an INT8
    cache (else None): a row's score is (q . k[s]) * scale (* ks[s]), and
    vs[s] weights v[s] only, never the denominator. ``new`` is the deferred
    form's self-term (k_new, ks_new, v_new, vs_new), or None. The old rows
    are the prefix, or with ``start`` the ring interval. Packed operands
    are unpacked to per-head views first (each pair scale serving both its
    heads) and the result packed back."""
    if packed:
        q = unpack_heads_rows(q)
        k, v = unpack_heads_seq(k), unpack_heads_seq(v)
        if ks is not None:
            ks, vs = unpack_pair_scales_seq(ks), unpack_pair_scales_seq(vs)
        if new is not None:
            kn, ksn, vn, vsn = new
            new = (unpack_heads_rows(kn), None if ksn is None else unpack_pair_scales_rows(ksn),
                   unpack_heads_rows(vn), None if vsn is None else unpack_pair_scales_rows(vsn))
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    valid = decode_valid_mask(k.shape[-2], length.to(q.device),
                              None if start is None else start.to(q.device))
    scores = torch.einsum("bhd,bhsd->bhs", qf, k.float()) * scale
    vf = v.float()
    if ks is not None:
        scores = scores * ks.float()
        # Scale planes outside the valid rows may hold anything (NaN
        # included): zero them before they weight V, since 0 * NaN is NaN.
        vf = vf * vs.float().masked_fill(~valid, 0.0)[..., None]
    s_self = v_self = None
    if new is not None:
        kn, ksn, vn, vsn = new
        s_self = (qf * kn.float()).sum(-1, keepdim=True) * scale
        v_self = vn.float()
        if ksn is not None:
            s_self = s_self * ksn.float()[..., None]
            v_self = v_self * vsn.float()[..., None]
    out = _softmax(scores, vf, valid, s_self, v_self).to(q.dtype)
    return pack_heads_rows(out) if packed else out


def decode_attention_deferred_plain(q, k_new, v_new, k_cache, v_cache, length,
                                    *, layer, start=None, packed=False):
    """The reference's math in plain PyTorch: the self-term seeds the
    softmax over the ``length`` OLD rows of layer ``layer``, all in f32.
    The old rows are the prefix, or with ``start`` the ring interval; the
    other rows are masked out of both sums (they hold stale data, or
    nothing yet)."""
    return _plain(q, (k_new, None, v_new, None), k_cache[layer], None,
                  v_cache[layer], None, length, start, packed)


def decode_attention_quant_deferred_plain(q, k_new, ks_new, v_new, vs_new,
                                          k_cache, k_scale, v_cache, v_scale,
                                          length, *, layer, start=None, packed=False):
    """The INT8 kernel's math in plain PyTorch, all in f32: a row's score is
    (q . k[s]) * scale * k_scale[s], and v_scale[s] weights v[s] only, never
    the denominator. The self-term is (k_new, ks_new, v_new, vs_new); the
    old rows are the prefix, or with ``start`` the ring interval."""
    return _plain(q, (k_new, ks_new, v_new, vs_new), k_cache[layer], k_scale[layer],
                  v_cache[layer], v_scale[layer], length, start, packed)


def decode_attention_plain(q, k_cache, v_cache, length, *, layer, start=None,
                           packed=False):
    """The appended form's math: softmax over the ``length`` rows of layer
    ``layer`` (the current row already appended), all in f32."""
    return _plain(q, None, k_cache[layer], None, v_cache[layer], None, length, start,
                  packed)


def decode_attention_quant_plain(q, k_cache, k_scale, v_cache, v_scale, length, *,
                                 layer, start=None, packed=False):
    """The appended form over an INT8 cache, all in f32."""
    return _plain(q, None, k_cache[layer], k_scale[layer], v_cache[layer],
                  v_scale[layer], length, start, packed)


# --- kernel wrappers -----------------------------------------------------------

def _check(q, k_cache, tensors, length, start, layer, packed):
    """Shape, device and contiguity checks shared by the wrappers.
    ``tensors`` is [(name, tensor, expected shape, expected dtype)];
    ``length`` and a given ``start`` must be (B,) int32. Returns the
    kernel's sizes (L, B, H, S, D): H counts heads, or head pairs when
    packed; D is the head dim."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32 or bfloat16)")
    L, B, H, S, W = k_cache.shape
    lanes = [("length", length, (B,), torch.int32)]
    if start is not None:
        lanes.append(("start", start, (B,), torch.int32))
    for name, t, shape, dtype in tensors + lanes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if packed and W != 128:
        raise ValueError(f"packed rows of {W} elements unsupported (head_dim 64 only)")
    if not packed and (W % 32 or not 32 <= W <= 128):
        raise ValueError(f"head_dim {W} unsupported (32, 64, 96 or 128)")
    for name, t, *_ in tensors:
        if t.dim() == 5 and t.data_ptr() % 16:  # the kernel's 16-byte row copies
            raise ValueError(f"{name} must be 16-byte aligned")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    return L, B, H, S, W // 2 if packed else W


# Split geometry of the attention kernel (csrc/decode_attention.cu): each
# block walks ``chunk`` logical rows of one (lane, row of heads), and the
# last block of the ``splits`` merges their partials. Chosen from (B, H, S)
# alone, never from ``length`` (on the card; reading it would cost the
# batcher a host sync, and a captured graph could not follow it). The chunk
# depends on B and H only: a split past a lane's rows adds exact zeros, so
# the same rows give the same bits in a cache of any S (an engine's cache
# and a shorter replay of the same request agree bit for bit).
_ATTN_MIN_BLOCKS = 132     # one block on each of the H100's 132 SMs
_ATTN_MAX_SPLITS = 16      # of a GPT-2 cache
_ATTN_SPAN = 1088          # rows of a GPT-2 cache: the 1024-token context and slack


def attention_splits(B: int, H: int, S: int) -> tuple[int, int]:
    """(splits, chunk) for a call over B lanes of H rows of heads (heads,
    or pairs when packed) with S cache rows: split s covers the logical rows
    [s * chunk, min((s + 1) * chunk, S)), so the splits cover [0, S) once.
    The chunk divides _ATTN_SPAN rows into the fewest power-of-two splits
    (at most _ATTN_MAX_SPLITS) that give every SM a block (B * H * splits
    >= _ATTN_MIN_BLOCKS): at B=1 the split fills the card, at B=16 the
    lanes already do."""
    if min(B, H, S) < 1:
        raise ValueError(f"attention_splits: B, H and S must be positive, got {B, H, S}")
    p = 1
    while B * H * p < _ATTN_MIN_BLOCKS and p < _ATTN_MAX_SPLITS:
        p *= 2
    chunk = -(-_ATTN_SPAN // p)
    return -(-S // chunk), chunk


_counted = tallies.counted("launches", "ring_launches", "packed_launches",
                           "packed_ring_launches", counters=("by_dtype",))


def _dtype_code(q_dtype, cache_dtype) -> int:
    """The kernel's dtype code: q's (0 float32, 1 bfloat16), plus for a
    float cache twice the cache's, so that the kernel reads each in its own
    type. An INT8 cache (``torch.int8``) adds nothing; another cache dtype
    raises."""
    if cache_dtype == torch.int8:
        return _DTYPE_CODES[q_dtype]
    if cache_dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported cache dtype {cache_dtype} (float32 or bfloat16)")
    return _DTYPE_CODES[q_dtype] + 2 * _DTYPE_CODES[cache_dtype]


def _launch(wrapper, q, ptrs, length, start, sizes, layer, packed, cache_dtype=torch.int8):
    """Launch the library's entry point for ``wrapper`` (``zg2_`` + its
    name, which takes a null ``start`` for the prefix rows and a packed
    flag) once, with the split geometry of ``attention_splits`` and, for
    more than one split, its scratch: the partials (B, H, splits, W + 4)
    f32 and the per-device tickets. Counts the launch. ``ptrs`` are the
    operands' data pointers before ``length``; ``cache_dtype`` the cache's
    dtype (int8 for an INT8 cache). Returns the output, like q."""
    code = _dtype_code(q.dtype, cache_dtype)
    _, B, H, S, D = sizes
    out = torch.empty_like(q)
    splits, chunk = attention_splits(B, H, S)
    scratch = (None, None)
    if splits > 1:  # held until the launch is enqueued
        scratch = (torch.empty((B, H, splits, q.shape[-1] + 4), dtype=torch.float32,
                               device=q.device), _build.tickets(q.device, B * H))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = getattr(_build.library(), "zg2_" + wrapper.__name__)
    variant = ("packed_" if packed else "") + ("ring_" if start is not None else "")
    partial, tickets = (None if t is None else t.data_ptr() for t in scratch)
    _build.check(entry(*ptrs, length.data_ptr(), None if start is None else start.data_ptr(),
                       out.data_ptr(), partial, tickets, B, H, S, D, int(layer), splits,
                       chunk, 1.0 / math.sqrt(D), code, int(packed),
                       stream),
                 f"{wrapper.__name__} ({variant or 'prefix_'}launch)")
    setattr(wrapper, variant + "launches", getattr(wrapper, variant + "launches") + 1)
    wrapper.by_dtype[(variant + "launches", *(str(t).removeprefix("torch.")
                                               for t in (q.dtype, cache_dtype)))] += 1
    return out


@_counted
def decode_attention_deferred(q, k_new, v_new, k_cache, v_cache, length, *,
                              layer, start=None, packed=False):
    """Attend over ``length`` old cache rows of layer ``layer`` plus the
    un-appended current row (k_new, v_new); identical in value to
    append-then-attend over length + 1 rows.

    q, k_new, v_new: (B, H, D); k_cache, v_cache: (L, B, H, S, D), or with
    ``packed`` (B, Hp, 2D) and (L, B, Hp, S, 2D) at head_dim 64; q, k_new
    and v_new float32 or bfloat16, the caches float32 or bfloat16 (each
    pair of one dtype, which may differ: each is read in its own type and
    the sums are f32); length: (B,) int32; layer: int; start: None
    for the prefix rows [0, length), or (B,) int32 for the ring interval
    [start, start + length) mod S. Returns q's shape and dtype. The kernel
    never reads the row that the caller appends next."""
    if q.device.type == "cpu":
        return decode_attention_deferred_plain(q, k_new, v_new, k_cache, v_cache, length,
                                               layer=layer, start=start, packed=packed)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_deferred: no kernel for {q.device}")
    L, B, H, S, W = k_cache.shape
    row, cache = ((B, H, W), q.dtype), ((L, B, H, S, W), k_cache.dtype)
    sizes = _check(q, k_cache, [("q", q, *row), ("k_new", k_new, *row),
                                ("v_new", v_new, *row), ("k_cache", k_cache, *cache),
                                ("v_cache", v_cache, *cache)],
                   length, start, layer, packed)
    ptrs = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr())
    return _launch(decode_attention_deferred, q, ptrs, length, start, sizes, layer, packed,
                   k_cache.dtype)


def _quant_specs(q, k_cache, rows, planes):
    """Expected (name, tensor, shape, dtype) of an INT8 call: q, then int8
    ``rows`` (B, H, W) with their f32 (B, H) scales, then the int8 caches
    with their f32 (L, B, H, S) ``planes``; each list alternates a tensor
    and its scales."""
    L, B, H, S, W = k_cache.shape
    i8, f32 = torch.int8, torch.float32
    specs = [("q", q, (B, H, W), q.dtype)]
    for i, (name, t) in enumerate(rows):
        specs.append((name, t, (B, H) if i % 2 else (B, H, W), f32 if i % 2 else i8))
    for i, (name, t) in enumerate(planes):
        specs.append((name, t, (L, B, H, S) if i % 2 else (L, B, H, S, W),
                       f32 if i % 2 else i8))
    return specs


@_counted
def decode_attention_quant_deferred(q, k_new, ks_new, v_new, vs_new, k_cache,
                                    k_scale, v_cache, v_scale, length, *, layer,
                                    start=None, packed=False):
    """``decode_attention_deferred`` over an INT8 cache.

    q: (B, H, D) float32 or bfloat16; k_new, v_new: (B, H, D) int8, the
    already-quantized rows that the caller appends next, with (B, H) f32
    scales ks_new, vs_new; k_cache, v_cache: (L, B, H, S, D) int8 with f32
    scale planes k_scale, v_scale (L, B, H, S); length: (B,) int32; start:
    None (prefix) or (B,) int32 (ring interval, planes read at the same
    rows). With ``packed`` every H is Hp and every D is 2D (head_dim 64),
    and the scales are per head pair. Returns q's shape and dtype."""
    if q.device.type == "cpu":
        return decode_attention_quant_deferred_plain(
            q, k_new, ks_new, v_new, vs_new, k_cache, k_scale, v_cache, v_scale,
            length, layer=layer, start=start, packed=packed)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant_deferred: no kernel for {q.device}")
    sizes = _check(q, k_cache, _quant_specs(
        q, k_cache, [("k_new", k_new), ("ks_new", ks_new), ("v_new", v_new),
                     ("vs_new", vs_new)],
        [("k_cache", k_cache), ("k_scale", k_scale), ("v_cache", v_cache),
         ("v_scale", v_scale)]), length, start, layer, packed)
    ptrs = (q.data_ptr(), k_new.data_ptr(), ks_new.data_ptr(), v_new.data_ptr(),
            vs_new.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(), v_cache.data_ptr(),
            v_scale.data_ptr())
    return _launch(decode_attention_quant_deferred, q, ptrs, length, start, sizes, layer,
                   packed)


@_counted
def decode_attention(q, k_cache, v_cache, length, *, layer, start=None, packed=False):
    """The appended form: attend over ``length`` rows of layer ``layer``
    (the current row already appended), with no self-term; ``length`` must
    be at least 1 on every lane (an empty lane is 0 / 0). Shapes, dtypes,
    ``start`` and ``packed`` as in ``decode_attention_deferred``."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length, layer=layer,
                                      start=start, packed=packed)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    L, B, H, S, W = k_cache.shape
    cache = ((L, B, H, S, W), k_cache.dtype)
    sizes = _check(q, k_cache, [("q", q, (B, H, W), q.dtype), ("k_cache", k_cache, *cache),
                                ("v_cache", v_cache, *cache)],
                   length, start, layer, packed)
    return _launch(decode_attention, q, (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()),
                   length, start, sizes, layer, packed, k_cache.dtype)


@_counted
def decode_attention_quant(q, k_cache, k_scale, v_cache, v_scale, length, *, layer,
                           start=None, packed=False):
    """The appended form over an INT8 cache: shapes and scales as in
    ``decode_attention_quant_deferred``, without the current row."""
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, k_cache, k_scale, v_cache, v_scale, length,
                                            layer=layer, start=start, packed=packed)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant: no kernel for {q.device}")
    sizes = _check(q, k_cache, _quant_specs(
        q, k_cache, [], [("k_cache", k_cache), ("k_scale", k_scale), ("v_cache", v_cache),
                         ("v_scale", v_scale)]), length, start, layer, packed)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(), v_cache.data_ptr(),
            v_scale.data_ptr())
    return _launch(decode_attention_quant, q, ptrs, length, start, sizes, layer, packed)
