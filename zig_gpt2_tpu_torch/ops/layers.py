"""Plain PyTorch ops: the numeric contract of the port.

Counterparts of ``zig_gpt2_tpu.ops.layers``, formula for formula, so that
the same weights give the same numbers: LayerNorm is the single-pass
``E[x^2] - mean^2`` with f32 statistics and eps inside the rsqrt (not
``F.layer_norm``), GELU is the sigmoid form of the tanh approximation (not
``F.gelu``), and softmax and attention statistics are f32 whatever the
activation dtype. Linear weights are ``(in, out)``. ``quantize_kv`` gives
the same int8 values and f32 scales as the JAX package's, bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# sqrt(2/pi) as the reference hardcodes it.
_GELU_C = 0.7978845608028654

# Large negative filler for masked scores. Not -inf: exp(-inf - -inf) would
# NaN in an all-masked row.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W (+ b), W stored (in, out)."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def embedding(idxs: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Row gather: out[i] = weight[idxs[i]]."""
    return weight[idxs]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance as E[x^2] - mean^2,
    eps inside the rsqrt, statistics in f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    inv = torch.rsqrt(var + eps)
    out = (xf - mean) * inv * weight.float() + bias.float()
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximation GELU in its sigmoid form x * sigmoid(2u),
    u = sqrt(2/pi) * x * (1 + 0.044715 x^2)."""
    xf = x.float()
    u = _GELU_C * xf * (1.0 + 0.044715 * xf * xf)
    return (xf * torch.sigmoid(2.0 * u)).to(x.dtype)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax with f32 statistics."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim, keepdim=True))
    return (e / e.sum(dim, keepdim=True)).to(x.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal attention (prefill).

    q, k, v: (B, H, T, D); length_mask: optional (B, T) bool, True where the
    key position is valid. Scores and softmax in f32; probabilities are
    rounded to v's dtype before the value product, as in the JAX op."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    tq, tk = scores.shape[-2], scores.shape[-1]
    row = torch.arange(tq, device=q.device)[:, None]
    col = torch.arange(tk, device=q.device)[None, :]
    mask = col <= row + (tk - tq)
    if length_mask is not None:
        mask = mask & length_mask[:, None, None, :]
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = softmax(scores, -1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def divide(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d, rounded as one IEEE division on every device. PyTorch's CUDA
    kernels multiply by the reciprocal of a Python-number divisor instead,
    which is one ulp off for some values: a quantization scale taken that
    way flips rounded int8 values against the JAX package's. A 0-d tensor
    on a's device is divided elementwise."""
    return a / a.new_full((), d)


def quantize_kv(x: torch.Tensor):
    """Per-row (per token, per head) symmetric INT8 quantization of K/V:
    (..., D) float -> (int8 (..., D), f32 scale (...,)), scale =
    absmax / 127 (at least 1e-12 / 127), values rounded half to even."""
    xf = x.float()
    scale = divide(torch.clamp(xf.abs().amax(-1), min=1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_valid_mask(max_seq: int, length: torch.Tensor,
                      start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 1, S) bool mask of each lane's valid cache rows (a scalar length
    gives (1, 1, S)). Without ``start``: the prefix [0, length[b]). With
    ``start`` (B,): the ring interval [start[b], start[b] + length[b]) mod
    S, as the ring cache holds a lane's rows."""
    pos = torch.arange(max_seq, device=length.device)
    if start is None:
        if length.dim() == 0:
            return (pos < length)[None, None, :]
        return (pos[None, :] < length[:, None])[:, None, :]
    rel = pos[None, :] - start.to(length.device)[:, None]  # (B, S)
    rel = rel + torch.where(rel < 0, max_seq, 0)
    return (rel < length[:, None])[:, None, :]


def _extend_mask(base: torch.Tensor, valid: torch.Tensor, T: int, S: int) -> torch.Tensor:
    """(B, T, S) bool mask of ``extend_attention``: window row t (absolute
    position base + t) sees the cache columns up to base + t, clipped to the
    window's valid rows (columns at or past base + valid hold padding).
    Padding query rows give garbage that callers discard."""
    col = torch.arange(S, device=base.device)
    row = torch.arange(T, device=base.device)
    limit = torch.minimum(base[:, None] + row[None, :] + 1, (base + valid)[:, None])
    return col[None, None, :] < limit[:, :, None]


def extend_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     base: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """T window queries over a (B, H, S, D) cache whose rows [base, base + T)
    were just appended (append, then attend: the window's causal structure
    is the column mask). q: (B, H, T, D); base, valid: (B,) int32. Scores
    and softmax in f32; probabilities rounded to v's dtype before the value
    product, as in the JAX op."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k_cache.float()) * scale
    mask = _extend_mask(base, valid, q.shape[-2], k_cache.shape[-2])
    probs = softmax(torch.where(mask[:, None], scores, MASK_VALUE), -1)
    out = torch.einsum("bhts,bhsd->bhtd", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.to(q.dtype)


def extend_attention_quant(q: torch.Tensor, k_cache: torch.Tensor, k_scale: torch.Tensor,
                           v_cache: torch.Tensor, v_scale: torch.Tensor,
                           base: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``extend_attention`` over an INT8 cache, k/v (B, H, S, D) int8 with
    scales (B, H, S): the K scale multiplies the score and the V scale
    folds into the probability. This is the JAX op's arithmetic, not the
    all-f32 decode kernel's: q and p * v_scale are rounded to bf16 (int8
    values are exact there), the products summed in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhtd,bhsd->bhts", q.to(torch.bfloat16).float(), k_cache.float())
    scores = scores * (k_scale[:, :, None, :] * scale)
    mask = _extend_mask(base, valid, q.shape[-2], k_cache.shape[-2])
    probs = softmax(torch.where(mask[:, None], scores, MASK_VALUE), -1)
    pv = (probs * v_scale[:, :, None, :]).to(torch.bfloat16).float()
    return torch.einsum("bhts,bhsd->bhtd", pv, v_cache.float()).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Single-query attention over a (B, H, S, D) cache whose first
    ``length`` rows are valid (the current row already appended)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), k_cache.float()) * scale
    valid = decode_valid_mask(k_cache.shape[-2], length)
    scores = torch.where(valid, scores, MASK_VALUE)
    probs = softmax(scores, -1)
    out = torch.einsum("bhs,bhsd->bhd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)
