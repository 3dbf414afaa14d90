"""Weight-only INT8 / INT4 quantization with grouped scales.

The port's own copy of ``zig_gpt2_tpu.quant.quantize``, same scheme and
same layouts, so a tree quantized by either package feeds the other:

- Symmetric absmax along the contraction (K) axis in groups of G rows:
  ``qw[k, n] = round(w[k, n] / scale[k // G, n])``, round half to even,
  clipped to [-127, 127] (INT8) or [-7, 7] (INT4). INT8 defaults to one
  group (G = K, per-channel scales); INT4 is grouped (``pick_group_size``).
- INT4 is packed two per int8 along K in the half-split layout: packed row
  p holds original row p in its low nibble and row p + K/2 in its high
  nibble.

Layout of a quantized linear dict (replaces ``{"w", "b"}``):

- INT8: ``{"qw":  int8 (..., K,   N), "scale": f32 (..., K/G, N), "b"?}``
- INT4: ``{"qw4": int8 (..., K/2, N), "scale": f32 (..., K/G, N), "b"?}``

Leading ``...`` dims (the per-layer stack axis) pass through.

``quantized_linear`` sends up to ``kernels.GEMV_MAX_ROWS`` rows to the
dequant-GEMV ``kernels.qmm`` (the CUDA kernel on the card, its plain
version on the CPU) and dequantizes larger row counts to the activation
dtype for one ``torch.matmul``. With ``act_quant`` (w8a8) a per-channel
INT8 linear quantizes its activations per row instead: up to
``kernels.W8A8_MAX_ROWS`` rows take the s8 x s8 body of ``qmm``, more rows
``w8a8_matmul``; grouped INT8 and INT4 stay weight-only. ``ZG2_QMM=0``
(the JAX package's escape hatch) sends every row count to the plain
routes instead: ``w8a8_matmul``, the grouped matmul up to GEMV_MAX_ROWS
rows, dequantize-then-matmul above.

Tensor-parallel layouts (``tp`` > 1, the JAX package's): a row-parallel
linear (c_proj) shards K over tp ranks, so its scale groups must divide
the per-rank K, and for INT4 also K/2 and K/(2 tp) (``pick_group_size``);
``quantize_params(tp=)`` applies that to the c_proj linears only.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from zig_gpt2_tpu_torch.ops.layers import divide
from zig_gpt2_tpu_torch.quant import kernels
from zig_gpt2_tpu_torch.quant.kernels import quantize_rows, unpack_int4

# Candidate group sizes, best first. INT4's half-split packing also needs
# K/2 % G == 0, which for 1.5B's K = 1600 projections gives G = 32.
_GROUP_CANDIDATES = (128, 64, 32, 16, 8)

_BLOCK_LINEARS = (
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "c_proj"),
    ("mlp", "c_fc"), ("mlp", "c_proj"),
)


def pick_group_size(k: int, mode: str, tp: int = 1) -> int:
    """Largest group size that divides K and K/tp (and, for INT4's
    half-split packing, K/2 and K/(2 tp)): with ``tp`` > 1 a row-parallel
    layer's groups then never straddle a rank's K range."""
    need = [k, k // tp]
    if mode == "int4":
        need += [k // 2, k // (2 * tp)]
    for g in _GROUP_CANDIDATES:
        if all(n % g == 0 for n in need):
            return g
    raise ValueError(f"no valid group size for K={k} ({mode}, tp={tp})")


def is_quantized(p: Dict[str, Any]) -> bool:
    return "qw" in p or "qw4" in p


def quantize_linear(p: Dict[str, Any], mode: str = "int8",
                    group_size: Optional[int] = None, tp: int = 1) -> Dict[str, Any]:
    """Quantize one ``{"w": (..., K, N), "b"?}`` linear. INT8 is
    per-channel unless ``group_size`` is given; INT4 is grouped, its group
    from ``pick_group_size(K, mode, tp)`` unless given (per-channel scales
    need no alignment: ``tp`` constrains grouped modes only)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    w = p["w"]
    k, n = w.shape[-2], w.shape[-1]
    g = k if group_size is None and mode == "int8" else (
        group_size or pick_group_size(k, mode, tp))
    if k % g:
        raise ValueError(f"K={k} not divisible by group_size={g}")
    qmax = 7.0 if mode == "int4" else 127.0
    grouped = w.float().reshape(*w.shape[:-2], k // g, g, n)
    absmax = grouped.abs().amax(dim=-2, keepdim=True)
    # All-zero columns (padded heads) have absmax 0: keep the scale finite.
    scale = divide(torch.clamp(absmax, min=1e-12), qmax)
    q = torch.clamp(torch.round(grouped / scale), -qmax, qmax).to(torch.int8)
    # Contiguous whatever w's strides (the lm_head comes from wte^T): the
    # kernel reads rows of qw and scale in place.
    q = q.reshape(w.shape).contiguous()
    out: Dict[str, Any] = {"scale": scale.squeeze(-2).contiguous()}  # (..., K/G, N)
    if mode == "int8":
        out["qw"] = q
    else:
        out.update(quantize_packed_int4(q))
    if p.get("b") is not None:
        out["b"] = p["b"]
    return out


def dequantize_linear(p: Dict[str, Any], dtype=torch.float32) -> Dict[str, Any]:
    """The float ``{"w", "b"?}`` that a quantized linear stands for: each
    weight is float(q) * its group's scale in f32, then cast to ``dtype``."""
    q = p["qw"] if "qw" in p else unpack_int4(p["qw4"])
    k, n = q.shape[-2], q.shape[-1]
    groups = p["scale"].shape[-2]
    grouped = q.float().reshape(*q.shape[:-2], groups, k // groups, n)
    w = (grouped * p["scale"][..., :, None, :]).reshape(q.shape)
    out = {"w": w.to(dtype)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def pad_linear(p: Dict[str, Any], *, n_out: int = 0, n_in: int = 0) -> Dict[str, Any]:
    """``p`` (float ``{"w", "b"?}`` or quantized) with ``n_out`` output
    columns and ``n_in`` input rows appended whose weights are exactly zero
    (zero bias entries; scale 1 for each new column and new group). An INT4
    weight is unpacked and packed again, since its half-split layout pairs
    rows K/2 apart."""
    out = dict(p)
    if p.get("b") is not None:
        out["b"] = F.pad(p["b"], (0, n_out))
    if "w" in p:
        out["w"] = F.pad(p["w"], (0, n_out, 0, n_in))
        return out
    q = p["qw"] if "qw" in p else unpack_int4(p["qw4"])  # (..., K, N)
    k, groups = q.shape[-2], p["scale"].shape[-2]
    g = k // groups
    new_groups = 0
    if groups > 1:  # grouped scales: the new rows make whole groups of their own
        new_groups = n_in // g
        if n_in % g or ("qw4" in p and ((k + n_in) // 2) % g):
            raise ValueError(f"{n_in} rows do not pad K={k} by whole groups of {g}")
    q = F.pad(q, (0, n_out, 0, n_in))
    out["scale"] = F.pad(p["scale"], (0, n_out, 0, new_groups), value=1.0).contiguous()
    if "qw4" in p:
        del out["qw4"]
        out.update(quantize_packed_int4(q))
    else:
        out["qw"] = q.contiguous()
    return out


def quantize_packed_int4(q: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{"qw4"}``: int8 INT4 values (..., K, N) in the half-split pack."""
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"INT4 packing needs an even K, not {k}")
    lo, hi = q.int().split(k // 2, dim=-2)  # rows [0, K/2), [K/2, K)
    return {"qw4": ((hi << 4) | (lo & 0x0F)).to(torch.int8)}


def grouped_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The JAX package's CPU formulation (``_grouped_matmul_jnp``): per-group
    partial dots of x (B, K) with the int8 q (K, N) cast to x's dtype, f32
    scales applied to the f32 partials. The port's own paths take ``qmm``,
    which follows the TPU kernel instead (scale folded into each weight);
    the two agree to f32 roundoff, which is what ties the port to the JAX
    model's CPU logits."""
    b, k = x.shape
    groups, n = scale.shape
    xg = x.reshape(b, groups, k // groups).transpose(0, 1).float()  # (groups, B, G)
    qg = q.to(x.dtype).float().reshape(groups, k // groups, n)
    partial = torch.bmm(xg, qg)  # (groups, B, N)
    return (partial * scale[:, None, :].float()).sum(0)


def _int_mm_takes(xq: torch.Tensor, qw: torch.Tensor) -> bool:
    """Whether ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32) takes this
    product: on the card, more than 16 rows, K and N multiples of 8."""
    return (xq.is_cuda and xq.shape[0] > 16 and xq.shape[1] % 8 == 0
            and qw.shape[1] % 8 == 0)


def w8a8_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(qw) with both operands int8: x quantized per row
    (``quantize_rows``), the int8 products summed exactly, then
    ``float(acc) * sx * scale[0]``. Per-channel scales only (scale (1, N)).
    The plain matrix product for the rows the GEMV kernel does not take:
    ``torch._int_mm`` on the CPU and on the card where its shape rules
    hold, else an f64 product (exact: |sum| <= K * 127^2 < 2^53). Both give
    the JAX package's int32 sums, so the result is the same bits either
    way. (rows, N) f32."""
    if scale.shape[0] != 1:
        raise ValueError(f"w8a8 needs per-channel scales (1, N), got {tuple(scale.shape)}")
    xq, sx = quantize_rows(x)
    if xq.device.type == "cpu" or _int_mm_takes(xq, qw):
        return kernels.w8a8_tail(torch._int_mm(xq, qw), sx, scale)
    return kernels.w8a8_tail(xq.double() @ qw.double(), sx, scale)


def _use_qmm() -> bool:
    """Whether quantized linears take the ``qmm`` GEMV kernel within its
    row cap (``ZG2_QMM``: ``1``, the default, on; ``0`` off, the JAX
    package's escape hatch)."""
    opt = os.environ.get("ZG2_QMM", "1")
    if opt not in ("0", "1"):
        raise ValueError(f"ZG2_QMM={opt!r}: expected 0 or 1")
    return opt == "1"


def quantized_product(p: Dict[str, Any], x2: torch.Tensor,
                      act_quant: bool = False) -> torch.Tensor:
    """(rows, K) x2 @ dequant(p) -> (rows, N), no bias: the routes of
    ``quantized_linear`` (f32 from the kernel, the w8a8 and grouped plain
    routes; x2's dtype from the dequantize-then-matmul route above
    GEMV_MAX_ROWS). The row-parallel linear all-reduces this before the
    cast and the bias."""
    int4 = "qw4" in p
    q = p["qw4"] if int4 else p["qw"]
    rows = x2.shape[0]
    w8a8 = act_quant and not int4 and p["scale"].shape[-2] == 1
    gemv = _use_qmm()
    if w8a8 and gemv and rows <= kernels.W8A8_MAX_ROWS:
        return kernels.qmm(x2.contiguous(), q, p["scale"], w8a8=True)
    if w8a8:
        return w8a8_matmul(x2, q, p["scale"])
    if gemv and rows <= kernels.GEMV_MAX_ROWS:
        return kernels.qmm(x2.contiguous(), q, p["scale"], int4=int4)
    if rows <= kernels.GEMV_MAX_ROWS:
        return grouped_matmul(x2, unpack_int4(q) if int4 else q, p["scale"])
    return torch.matmul(x2, dequantize_linear(p, dtype=x2.dtype)["w"])


def quantized_linear(p: Dict[str, Any], x: torch.Tensor,
                     act_quant: bool = False) -> torch.Tensor:
    """y = x @ dequant(p) (+ b), in x's dtype. Up to GEMV_MAX_ROWS rows run
    the dequant-GEMV kernel, which never materializes the float weight;
    more rows dequantize to x's dtype and take one matmul. ``act_quant``
    (w8a8) applies to a per-channel INT8 linear only: up to W8A8_MAX_ROWS
    rows run the kernel's s8 x s8 body, more rows ``w8a8_matmul``. Under
    ``ZG2_QMM=0`` no row count runs the kernel: w8a8 takes ``w8a8_matmul``
    and up to GEMV_MAX_ROWS rows ``grouped_matmul``. The f32 product is cast
    to x's dtype before the bias is added."""
    *lead, k_in = x.shape
    y = quantized_product(p, x.reshape(-1, k_in), act_quant)
    y = y.to(x.dtype).reshape(*lead, y.shape[-1])
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def quantize_params(params: Dict[str, Any], mode: str = "int8",
                    group_size: Optional[int] = None, quantize_lm_head: bool = True,
                    tp: int = 1) -> Dict[str, Any]:
    """Quantize every block linear of a GPT-2 tree and, with
    ``quantize_lm_head``, untie the lm_head into ``params["lm_head"]``
    quantized from wte^T. Embeddings and LayerNorms stay float (wte is
    still the embedding table). The lm_head is INT8 even in INT4 mode, as
    in the JAX package; ``group_size`` (None: per-channel INT8, or
    ``pick_group_size`` for INT4) applies to every linear, the lm_head
    included. ``tp``: the model-parallel degree the row-parallel c_proj
    layouts are aligned for (``pick_group_size``); pad the tree for it
    first (``parallel.sharding.pad_for_tp``)."""
    params = dict(params)
    blocks = dict(params["blocks"])
    for mod, name in _BLOCK_LINEARS:
        sub = dict(blocks[mod])
        sub[name] = quantize_linear(sub[name], mode, group_size,
                                    tp=tp if name == "c_proj" else 1)
        blocks[mod] = sub
    params["blocks"] = blocks
    if quantize_lm_head and "lm_head" not in params:
        lm_mode = "int8" if mode == "int4" else mode
        params["lm_head"] = quantize_linear({"w": params["wte"].T}, lm_mode, group_size)
    return params
