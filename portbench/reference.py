"""The yardstick's shared arithmetic, and the plain reference that decides
``correct``.

Each model family's ``Reference`` (``portbench/families/<model_type>/
model.py``) is plain PyTorch over the raw weights that family's
``make_weights`` draws, with no kernel, cache or batching of the program.
What a configuration states about quantization it re-does with the frozen
copy of the arithmetic below (never the program's tensors):

- ``fake_quant``: symmetric absmax over K in groups, ``q = clamp(round(w /
  s), -qmax, qmax)`` with ``s = max(absmax, 1e-12) / qmax`` (one IEEE
  division), used as ``q * s``;
- ``fake_quant_kv``: a KV row's INT8 round trip per head or per pair of
  adjacent heads (an odd last head paired with a zero head).

``precision`` (``matmul``) puts a lower precision in place of float32, for
the control of the check: ``tf32`` rounds both operands of every product to
TF32 (10 mantissa bits, round to nearest even), ``fp8`` rounds every
activation operand of a product to float8 e4m3 (weights stay as
dequantized).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from portbench.spec import family

_FP8_MAX = 448.0
PRECISIONS = (None, "tf32", "fp8")


def _divide(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d as one IEEE division (a 0-d tensor divisor: a Python number is
    taken as a multiply by its reciprocal on the card)."""
    return a / a.new_full((), d)


def fake_quant(w: torch.Tensor, qmax: float, group: int) -> torch.Tensor:
    """(..., K, N) weights -> f32 ``q * s``, absmax over K in groups of ``group``."""
    k, n = w.shape[-2], w.shape[-1]
    g = w.float().reshape(*w.shape[:-2], k // group, group, n)
    s = _divide(torch.clamp(g.abs().amax(-2, keepdim=True), min=1e-12), qmax)
    q = torch.clamp(torch.round(g / s), -qmax, qmax)
    return (q * s).reshape(w.shape)


def fake_quant_kv(x: torch.Tensor, pairs: bool) -> torch.Tensor:
    """(T, H, D) -> f32 INT8 round trip per (position, head) or per
    (position, head pair)."""
    T, H, D = x.shape
    if pairs:
        x = F.pad(x, (0, 0, 0, H % 2)).reshape(T, (H + 1) // 2, 2 * D)
    s = _divide(torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / s), -127, 127) * s
    return q.reshape(T, -1, D)[:, :H] if pairs else q


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return x.float().clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).float()


def check_precision(precision: Optional[str]) -> Optional[str]:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return precision


def matmul(a: torch.Tensor, b: torch.Tensor, precision: Optional[str],
           b_is_weight: bool) -> torch.Tensor:
    """``a @ b`` in ``precision`` (None: float32 as it is)."""
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif precision == "fp8":
        a = round_fp8(a)
        if not b_is_weight:
            b = round_fp8(b)
    return torch.matmul(a, b)


def Reference(weights: dict, config: dict, precision: Optional[str] = None):  # noqa: N802
    """The plain reference of the configuration's model family."""
    return family(config).model.Reference(weights, config, precision)
