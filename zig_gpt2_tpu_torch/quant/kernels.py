"""Fused dequant GEMV for weight-only INT8 / INT4: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``zig_gpt2_tpu.quant.kernels.qmm`` (body ``_qmm_kernel``),
per-layer form: ``y[rows, N] = x[rows, K] @ dequant(qw, scale)[K, N]`` in
f32, reading the int8 or packed-int4 weight straight from device memory.
The kernel is ``ops/csrc/qmm.cu``. A CUDA tensor launches it (or the
wrapper raises); a CPU tensor runs ``qmm_plain``.

The numerics are the TPU kernel's:

- grouped scales (INT4, and INT8 with a group size): each weight is
  ``float(q) * scale[k // G, n]`` in f32, rounded to x's dtype, and the
  products with x are summed in f32;
- per-channel scales (one group: the INT8 default and the lm_head): the
  sum of ``x * q`` in f32, times ``scale[0, n]`` once at the end.

A bf16 x times a bf16 (or int8) weight is exact in f32, so the two dtypes
differ only in the rounding of the weight, never of the products.

The JAX package's stacked mode (the whole ``(L, ...)`` weight plus a layer
index) exists so that XLA does not copy a layer's slice; here the caller
passes the view ``qw[idx]``, which copies nothing.
"""

from __future__ import annotations

import torch

from zig_gpt2_tpu_torch.ops import _build

# Row cap of the GEMV path (the JAX package's GEMV_MAX_ROWS): larger row
# counts dequantize and take a plain matmul (quantize.quantized_linear).
GEMV_MAX_ROWS = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def unpack_int4(qw4: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) packed int4 -> (..., K, N) int8 in [-7, 7]. Low
    nibbles are rows [0, K/2), high nibbles rows [K/2, K). The nibbles are
    sign-extended in int32 as ((v & 15) ^ 8) - 8, as the kernel does."""
    p = qw4.int()
    lo = ((p & 15) ^ 8) - 8
    hi = (((p >> 4) & 15) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def qmm_plain(x, qw, scale, *, int4=False):
    """The kernel's arithmetic in plain PyTorch: (rows, N) f32."""
    q = unpack_int4(qw) if int4 else qw
    k, n = q.shape
    groups = scale.shape[0]
    if groups == 1:
        return (x.float() @ q.float()) * scale[0].float()
    w = (q.float().reshape(groups, k // groups, n) * scale[:, None, :].float())
    w = w.reshape(k, n).to(x.dtype).float()
    return x.float() @ w


def qmm(x, qw, scale, *, int4=False):
    """y = x @ dequant(qw, scale) in f32.

    x: (rows, K) float32 or bfloat16, 1 <= rows <= GEMV_MAX_ROWS; qw: (K, N)
    int8, or (K/2, N) int8 holding the INT4 half-split pack when ``int4``;
    scale: (K/G, N) float32, G = K for per-channel. All contiguous, on one
    device. Returns (rows, N) float32."""
    if x.device.type == "cpu":
        return qmm_plain(x, qw, scale, int4=int4)
    if x.device.type != "cuda":
        raise ValueError(f"qmm: no kernel for {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be (rows, K) float32/bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    rows, k = x.shape
    if not 1 <= rows <= GEMV_MAX_ROWS:
        raise ValueError(f"qmm takes 1 to {GEMV_MAX_ROWS} rows, got {rows}")
    if qw.dim() != 2 or qw.dtype != torch.int8:
        raise ValueError(f"qw must be 2-D int8, got {tuple(qw.shape)} {qw.dtype}")
    kp, n = qw.shape
    if kp != (k // 2 if int4 else k) or (int4 and k % 2):
        raise ValueError(f"qw rows {kp} do not match K={k} ({'int4' if int4 else 'int8'})")
    if scale.dim() != 2 or scale.dtype != torch.float32 or scale.shape[1] != n:
        raise ValueError(f"scale must be (K/G, {n}) float32, got {tuple(scale.shape)} "
                         f"{scale.dtype}")
    groups = scale.shape[0]
    if groups < 1 or k % groups:
        raise ValueError(f"{groups} scale groups do not divide K={k}")
    for name, t in (("x", x), ("qw", qw), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    splits = _k_splits(rows, n, kp)
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, rows, n), dtype=torch.float32, device=x.device)
               if splits > 1 else out)
    err = _build.library().zg2_qmm(
        x.data_ptr(), qw.data_ptr(), scale.data_ptr(), partial.data_ptr(),
        out.data_ptr(), rows, k, n, k // groups, splits, int(int4),
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qmm")
    qmm.launches += 1
    return out


qmm.launches = 0

# Launch geometry shared with csrc/qmm.cu: one thread per output column,
# _QMM_COLS columns per block, row tiles of 8 (1 for a single row).
_QMM_COLS = 128
_TARGET_BLOCKS = 132 * 8  # about eight blocks on each of the H100's 132 SMs
_MIN_SPLIT_ROWS = 32      # packed weight rows per K split, at least


def _k_splits(rows: int, n: int, kp: int) -> int:
    """How many K ranges the kernel splits the weight into (each block
    sums one range; a second pass adds the ranges in order, so the result
    does not depend on the launch). Enough blocks to fill the card, and
    no range shorter than _MIN_SPLIT_ROWS packed rows."""
    tiles = -(-n // _QMM_COLS) * (1 if rows == 1 else -(-rows // 8))
    want = -(-_TARGET_BLOCKS // tiles)
    return max(1, min(want, kp // _MIN_SPLIT_ROWS))
