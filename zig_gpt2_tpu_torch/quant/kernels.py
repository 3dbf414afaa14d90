"""The decode GEMVs: the CUDA kernels' wrappers and their plain PyTorch
versions.

``qmm`` is the counterpart of ``zig_gpt2_tpu.quant.kernels.qmm`` (body
``_qmm_kernel``), per-layer form: ``y[rows, N] = x[rows, K] @ dequant(qw,
scale)[K, N]`` in f32, reading the int8 or packed-int4 weight straight from
device memory, with its w8a8 body (``w8a8=True``: per-row INT8 activations
times the per-channel INT8 weight in int32). ``wmm`` is the counterpart of
``zig_gpt2_tpu.quant.kernels.wmm`` (body ``_wmm_kernel``): ``y = x @ w`` in
f32 for float weights. The kernels are ``ops/csrc/qmm.cu`` and
``ops/csrc/wmm.cu``. A CUDA tensor launches them (or the wrapper raises); a
CPU tensor runs ``qmm_plain`` / ``wmm_plain``.

The numerics are the TPU kernel's:

- grouped scales (INT4, and INT8 with a group size): each weight is
  ``float(q) * scale[k // G, n]`` in f32, rounded to x's dtype, and the
  products with x are summed in f32;
- per-channel scales (one group: the INT8 default and the lm_head): the
  sum of ``x * q`` in f32, times ``scale[0, n]`` once at the end.

- w8a8 (per-channel INT8 only, as the TPU kernel gates it): each row of x
  is quantized to int8 (``quantize_rows``: absmax / 127, round half to
  even, clip to +-127), the products with q are summed in int32 (exact),
  and the output is ``float(acc) * sx[r] * scale[0, n]`` in that order, so
  kernel and plain version agree bit for bit.

A bf16 x times a bf16 (or int8) weight is exact in f32, so the two dtypes
differ only in the rounding of the weight, never of the products.

The JAX package's stacked mode (the whole ``(L, ...)`` weight plus a layer
index) exists so that XLA does not copy a layer's slice; here the caller
passes the view ``qw[idx]``, which copies nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from zig_gpt2_tpu_torch.ops import _build, tallies
from zig_gpt2_tpu_torch.ops.layers import divide

# Row caps of the GEMV paths (the JAX package's GEMV_MAX_ROWS and
# W8A8_MAX_ROWS): larger row counts dequantize and take a plain matmul, or
# for w8a8 the plain s8 x s8 product (quantize.quantized_linear).
GEMV_MAX_ROWS = 256
W8A8_MAX_ROWS = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def unpack_int4(qw4: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) packed int4 -> (..., K, N) int8 in [-7, 7]. Low
    nibbles are rows [0, K/2), high nibbles rows [K/2, K). The nibbles are
    sign-extended in int32 as ((v & 15) ^ 8) - 8, as the kernel does."""
    p = qw4.int()
    lo = ((p & 15) ^ 8) - 8
    hi = (((p >> 4) & 15) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def quantize_rows(x: torch.Tensor):
    """Dynamic per-row symmetric INT8 quantization of activations:
    (..., K) float -> ((..., K) int8, (...,) f32 row scales), the JAX
    package's ``quantize_rows`` bit for bit (f32 absmax, scale
    max(absmax, 1e-12) / 127, x / scale rounded half to even, clipped)."""
    xf = x.float()
    sx = divide(xf.abs().amax(dim=-1).clamp(min=1e-12), 127.0)
    xq = torch.round(xf / sx[..., None]).clamp(-127, 127).to(torch.int8)
    return xq, sx


def w8a8_tail(acc: torch.Tensor, sx: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(rows, N) f32 output from the exact integer sums ``acc`` (int32, or
    whole numbers in f64): converted once to f32, then times the row scale
    and the column scale, in that order."""
    return acc.float() * sx[:, None] * scale[0]


def _uses_w8a8(w8a8: bool, int4: bool, scale: torch.Tensor) -> bool:
    """w8a8 applies to per-channel INT8 only (the TPU kernel's gate);
    another weight stays weight-only."""
    return w8a8 and not int4 and scale.shape[0] == 1


def qmm_plain(x, qw, scale, *, int4=False, w8a8=False):
    """The kernel's arithmetic in plain PyTorch: (rows, N) f32. The w8a8
    product is the kernel's exact int32 sums: ``torch._int_mm`` on the CPU,
    on the card an f64 product, exact here (|sum| <= K * 127^2 < 2^53)."""
    if _uses_w8a8(w8a8, int4, scale):
        xq, sx = quantize_rows(x)
        acc = torch._int_mm(xq, qw) if xq.device.type == "cpu" else xq.double() @ qw.double()
        return w8a8_tail(acc, sx, scale)
    q = unpack_int4(qw) if int4 else qw
    k, n = q.shape
    groups = scale.shape[0]
    if groups == 1:
        return (x.float() @ q.float()) * scale[0].float()
    w = (q.float().reshape(groups, k // groups, n) * scale[:, None, :].float())
    w = w.reshape(k, n).to(x.dtype).float()
    return x.float() @ w


@tallies.counted("launches", "w8a8_launches", counters=("by_shape",))
def qmm(x, qw, scale, *, int4=False, w8a8=False):
    """y = x @ dequant(qw, scale) in f32.

    x: (rows, K) float32 or bfloat16, 1 <= rows <= GEMV_MAX_ROWS; qw: (K, N)
    int8, or (K/2, N) int8 holding the INT4 half-split pack when ``int4``;
    scale: (K/G, N) float32, G = K for per-channel. All contiguous, on one
    device. ``w8a8`` takes the s8 x s8 body for a per-channel INT8 weight
    (rows <= W8A8_MAX_ROWS) and is ignored for any other weight. Returns
    (rows, N) float32. One launch per call (the K split and its combine are
    in the kernel: ``qmm_geometry``, ``w8a8_geometry``). Launches count in
    ``qmm.launches``, w8a8 launches in ``qmm.w8a8_launches``, and both per
    (body, K, N, rows) in ``qmm.by_shape`` (body "int8", "int4" or
    "w8a8")."""
    if x.device.type == "cpu":
        return qmm_plain(x, qw, scale, int4=int4, w8a8=w8a8)
    if x.device.type != "cuda":
        raise ValueError(f"qmm: no kernel for {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be (rows, K) float32/bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    rows, k = x.shape
    w8a8 = _uses_w8a8(w8a8, int4, scale)
    cap = W8A8_MAX_ROWS if w8a8 else GEMV_MAX_ROWS
    if not 1 <= rows <= cap:
        raise ValueError(f"qmm{' (w8a8)' if w8a8 else ''} takes 1 to {cap} rows, got {rows}")
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
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if w8a8:
        geo = w8a8_geometry(rows, k, n)
        scratch = (None, None)
        if geo.splits > 1 and not geo.cluster:  # held until the launch is enqueued
            scratch = (torch.empty((geo.splits, geo.tiles, rows, _QMM_COLS), dtype=torch.int32,
                                   device=x.device),
                       _build.tickets(x.device, geo.tiles))
        partial, tickets = (None if t is None else t.data_ptr() for t in scratch)
        err = _build.library().zg2_qmm_w8a8(
            x.data_ptr(), qw.data_ptr(), scale.data_ptr(), partial, tickets, out.data_ptr(),
            rows, k, n, geo.splits, geo.split_rows, geo.m_tiles, int(geo.cluster),
            _DTYPE_CODES[x.dtype], stream)
        _build.check(err, "qmm (w8a8)")
        qmm.w8a8_launches += 1
        qmm.by_shape[("w8a8", k, n, rows)] += 1
        return out
    geo = qmm_geometry(rows, k, n, int4, x.dtype)
    scratch = (None, None)
    if geo.splits > 1:  # held until the launch is enqueued
        scratch = (torch.empty((geo.splits, rows, n), dtype=torch.float32, device=x.device),
                   _build.tickets(x.device, geo.tiles))
    partial, tickets = (None if t is None else t.data_ptr() for t in scratch)
    err = _build.library().zg2_qmm(
        x.data_ptr(), qw.data_ptr(), scale.data_ptr(), partial, tickets, out.data_ptr(),
        rows, k, n, k // groups, geo.splits, geo.split_rows, geo.row_tile, int(int4),
        _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "qmm")
    qmm.launches += 1
    qmm.by_shape[("int4" if int4 else "int8", k, n, rows)] += 1
    return out



def wmm_plain(x, w):
    """The float GEMV's arithmetic in plain PyTorch: the weight rounded to
    x's dtype, f32 products and sums. (rows, N) f32."""
    return x.float() @ w.to(x.dtype).float()


@tallies.counted("launches", counters=("by_shape",))
def wmm(x, w):
    """y = x @ w.astype(x.dtype) in f32: the float-weight decode GEMV.

    x: (rows, K) float32 or bfloat16, 1 <= rows <= GEMV_MAX_ROWS; w: (K, N)
    float32 or bfloat16. Both contiguous, on one device. Returns (rows, N)
    float32. One launch per call (the K split and its combine are in the
    kernel: ``wmm_geometry``). Launches count in ``wmm.launches``, and per
    (x's dtype name, K, N, rows) in ``wmm.by_shape``."""
    if x.device.type == "cpu":
        return wmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"wmm: no kernel for {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be (rows, K) float32/bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    rows, k = x.shape
    if not 1 <= rows <= GEMV_MAX_ROWS:
        raise ValueError(f"wmm takes 1 to {GEMV_MAX_ROWS} rows, got {rows}")
    if w.dim() != 2 or w.dtype not in _DTYPE_CODES or w.shape[0] != k:
        raise ValueError(f"w must be ({k}, N) float32/bfloat16, got {tuple(w.shape)} "
                         f"{w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    n = w.shape[1]
    geo = wmm_geometry(rows, k, n, x.dtype, w.dtype)
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    scratch = (None, None)
    if geo.splits > 1 and not geo.cluster:  # held until the launch is enqueued
        tiles = -(-rows // geo.row_tile) * -(-n // geo.col_tile)
        scratch = (torch.empty((tiles, geo.splits, geo.row_tile * geo.col_tile),
                               dtype=torch.float32, device=x.device),
                   _build.tickets(x.device, tiles))
    partial, tickets = (None if t is None else t.data_ptr() for t in scratch)
    err = _build.library().zg2_wmm(
        x.data_ptr(), w.data_ptr(), partial, tickets, out.data_ptr(), rows, k, n,
        geo.splits, geo.split_rows, geo.row_tile, int(geo.cluster), _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[w.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "wmm")
    wmm.launches += 1
    wmm.by_shape[(str(x.dtype).removeprefix("torch."), k, n, rows)] += 1
    return out


# Launch geometry of csrc/wmm.cu: a row tile of x and a column tile per
# block (64 columns on the CUDA cores, 128 on the tensor cores); K split into
# ranges of split_rows weight rows (whole _WMM_TILE_ROWS-row tiles), added in
# split order in a thread-block cluster of the output tile's splits (up to
# _WMM_CLUSTER_SPLITS) or by the last block to take the tile's ticket. The
# block counts and the least weight per block are the best of a sweep of
# geometries at GPT-2 124M's shapes on the H100 (tools/wmm_sweep.py;
# PERF.md, PR 8).
_WMM_TILE_ROWS = 32
_WMM_SIMT_COLS = 64
_WMM_MMA_COLS = 128
_WMM_BLOCKS_SIMT = 96        # blocks to aim at: CUDA cores (fewer, longer ranges)
_WMM_BLOCKS_MMA = 192        # ... tensor cores (about 1.5 blocks per SM)
_WMM_MIN_BYTES_SIMT = 24576  # weight bytes per block, at least: CUDA cores
_WMM_MIN_BYTES_MMA = 16384   # ... tensor cores
_WMM_X_BYTES = 32768        # x of a block's range in shared memory
_WMM_X_BYTES_WIDE = 65536   # ... for the 64-row tensor-core body
_WMM_CLUSTER_SPLITS = 16    # the kernel's largest (non-portable) cluster


@dataclasses.dataclass(frozen=True)
class WmmGeometry:
    """One wmm launch: ``row_tile`` rows of x per block (1 or 4 on the CUDA
    cores, 16 or 64 on the tensor cores), ``col_tile`` columns per block (64
    or 128, the body's), and the K split: ``splits`` ranges of
    ``split_rows`` weight rows, added in a thread-block cluster of the output
    tile's splits when ``cluster``, else by the last block to take the
    tile's ticket."""
    row_tile: int
    col_tile: int
    splits: int
    split_rows: int
    cluster: bool


def wmm_geometry(rows: int, k: int, n: int, xdtype, wdtype) -> WmmGeometry:
    """The wmm launch for x (rows, K) of ``xdtype`` and a (K, N) weight of
    ``wdtype``, from these shapes alone. Two or more bf16 rows take the
    tensor cores (16-row tiles up to 16 rows, else 64), one row or f32 x the
    CUDA cores (1 row, else tiles of 4). The K split aims at the body's
    block count (_WMM_BLOCKS_SIMT, _WMM_BLOCKS_MMA) with at least the
    body's least weight each (_WMM_MIN_BYTES_SIMT, _WMM_MIN_BYTES_MMA), in
    whole tiles, a range's x within the body's shared memory; it takes the
    fewest splits that make one cluster when that aim would need more."""
    if not 1 <= rows <= GEMV_MAX_ROWS or min(k, n) < 1:
        raise ValueError(f"wmm_geometry: rows in 1..{GEMV_MAX_ROWS}, K and N positive, "
                         f"got {rows, k, n}")
    mma = xdtype == torch.bfloat16 and rows > 1
    if mma:
        row_tile, col_tile = (16 if rows <= 16 else 64), _WMM_MMA_COLS
        budget = _WMM_X_BYTES_WIDE if row_tile == 64 else _WMM_X_BYTES
        cap = budget // (2 * row_tile) - 8  # bf16 x, rows padded by 8 elements
    else:
        row_tile, col_tile = (1 if rows == 1 else 4), _WMM_SIMT_COLS
        cap = _WMM_X_BYTES // (4 * row_tile)  # f32 x
    t = _WMM_TILE_ROWS

    def tiles_of(r):
        return min(-(-r // t) * t, cap // t * t)

    blocks, min_bytes = ((_WMM_BLOCKS_MMA, _WMM_MIN_BYTES_MMA) if mma else
                         (_WMM_BLOCKS_SIMT, _WMM_MIN_BYTES_SIMT))
    want = -(-blocks // (-(-rows // row_tile) * -(-n // col_tile)))
    least = min_bytes // (col_tile * (4 if wdtype == torch.float32 else 2))
    split_rows = tiles_of(min(max(-(-k // want), least), k))
    if -(-k // split_rows) > _WMM_CLUSTER_SPLITS:
        split_rows = max(split_rows, tiles_of(-(-k // _WMM_CLUSTER_SPLITS)))
    splits = -(-k // split_rows)
    return WmmGeometry(row_tile, col_tile, splits, split_rows,
                       1 < splits <= _WMM_CLUSTER_SPLITS)


# Launch geometry of qmm's weight-only bodies (csrc/qmm.cu): blocks of
# _QMM_COLS columns and a row tile of x; K split into ranges of split_rows
# packed rows (a multiple of the kernel's _QMM_TILE_ROWS-row tiles), merged
# in split order by the last block of each output tile.
_QMM_COLS = 128
_QMM_TILE_ROWS = 64
_QMM_SLOTS = 2 * 132        # two resident blocks on each of the H100's 132 SMs
_QMM_X_BYTES = 32768        # x of a block's range in shared memory
_QMM_X_BYTES_WIDE = 65536   # ... for the 64-row tensor-core body


@dataclasses.dataclass(frozen=True)
class QmmGeometry:
    """One weight-only qmm launch: ``row_tile`` rows of x per block (1 or
    4 on the CUDA cores, 16 or 64 on the tensor cores), ``tiles`` output
    tiles (row tiles x column tiles; one ticket each), and the K split:
    ``splits`` ranges of ``split_rows`` packed weight rows."""
    row_tile: int
    tiles: int
    splits: int
    split_rows: int


def qmm_geometry(rows: int, k: int, n: int, int4: bool, dtype) -> QmmGeometry:
    """The weight-only launch for x (rows, K) of ``dtype`` and an N-column
    weight, from these shapes alone. Two or more bf16 rows take the tensor
    cores (16-row tiles up to 16 rows, else 64), one row or f32 x the CUDA
    cores (1 row, else tiles of 4). The K split aims at _QMM_SLOTS blocks,
    in ranges that are whole tiles; with more than one row it keeps the
    partial sums (4 bytes per row, column and split) below the weight's
    bytes; and a range's x must fit the body's shared memory."""
    if min(rows, k, n) < 1:
        raise ValueError(f"qmm_geometry: rows, K and N must be positive, got {rows, k, n}")
    if dtype == torch.bfloat16 and rows > 1:
        row_tile = 16 if rows <= 16 else 64
    else:
        row_tile = 1 if rows == 1 else 4
    width = 2 if int4 else 1
    if row_tile >= 16:  # bf16 x, rows padded by 8 elements
        budget = _QMM_X_BYTES_WIDE if row_tile == 64 else _QMM_X_BYTES
        cap = (budget // (2 * row_tile) - 8) // width
    else:  # f32 x
        cap = _QMM_X_BYTES // (4 * row_tile * width)
    cap = cap // _QMM_TILE_ROWS * _QMM_TILE_ROWS
    p = k // 2 if int4 else k
    tiles = -(-rows // row_tile) * -(-n // _QMM_COLS)
    want = -(-_QMM_SLOTS // tiles)
    if rows > 1:
        want = min(want, max(1, p // (4 * rows)))
    split_rows = -(-p // want)
    split_rows = -(-split_rows // _QMM_TILE_ROWS) * _QMM_TILE_ROWS
    split_rows = min(split_rows, cap)
    return QmmGeometry(row_tile, tiles, -(-p // split_rows), split_rows)


# Launch geometry of qmm's w8a8 body (csrc/qmm.cu qmm_w8a8_kernel): all the
# call's rows in 16-row tiles per block, _QMM_COLS columns, K split into
# ranges of split_rows weight rows (whole _QMM_TILE_ROWS-row tiles) added
# by the last block of each column tile from int32 partials laid out
# (splits, tiles, rows, _QMM_COLS). xq of a range is staged in shared
# memory as int8, rows 16 bytes longer than the range. A narrow weight
# (fewer than _W8A8_CLUSTER_TILES column tiles) with a short K (at most
# _W8A8_CLUSTER_SPLITS ranges of _W8A8_CLUSTER_ROWS rows) takes that many
# splits and adds them in a thread-block cluster instead: the attention
# linears of GPT-2 1.5B (13 tiles, K 1600 or 1664: 7 splits).
_W8A8_CLUSTER_TILES = 32
_W8A8_CLUSTER_SPLITS = 8     # the portable cluster size
_W8A8_CLUSTER_ROWS = 256
_W8A8_SLOTS = 2 * 132        # two resident blocks on each of the H100's 132 SMs
_W8A8_X_BYTES = 32768        # xq of a block's range: one 16-row tile
_W8A8_X_BYTES_WIDE = 65536   # ... two or four


@dataclasses.dataclass(frozen=True)
class W8a8Geometry:
    """One w8a8 launch: ``m_tiles`` 16-row tiles (every row of the call in
    each block), ``tiles`` column tiles, and the K split: ``splits`` ranges
    of ``split_rows`` weight rows, added in a thread-block cluster of the
    column tile's splits when ``cluster``, else by the last block to take
    the column tile's ticket."""
    m_tiles: int
    tiles: int
    splits: int
    split_rows: int
    cluster: bool


def w8a8_geometry(rows: int, k: int, n: int) -> W8a8Geometry:
    """The w8a8 launch for x (rows, K) and a (K, N) INT8 weight, from these
    shapes alone. The K split aims at _W8A8_SLOTS blocks, in ranges that
    are whole tiles; with more than one row it keeps the int32 partial sums
    (4 bytes per row, column and split) below the weight's bytes; and a
    range's xq must fit the body's shared memory. A narrow weight with a
    short K splits into at most _W8A8_CLUSTER_SPLITS ranges instead, added
    in a cluster (no partial sums in device memory, no ticket)."""
    if not 1 <= rows <= W8A8_MAX_ROWS or min(k, n) < 1:
        raise ValueError(f"w8a8_geometry: rows in 1..{W8A8_MAX_ROWS}, K and N positive, "
                         f"got {rows, k, n}")
    m_tiles = 1 if rows <= 16 else 2 if rows <= 32 else 4
    budget = _W8A8_X_BYTES if m_tiles == 1 else _W8A8_X_BYTES_WIDE
    cap = (budget // (16 * m_tiles) - 16) // _QMM_TILE_ROWS * _QMM_TILE_ROWS
    tiles = -(-n // _QMM_COLS)
    want = -(-_W8A8_SLOTS // tiles)
    if rows > 1:
        want = min(want, max(1, k // (4 * rows)))
    split_rows = -(-k // want)
    split_rows = -(-split_rows // _QMM_TILE_ROWS) * _QMM_TILE_ROWS
    split_rows = min(split_rows, cap)
    if tiles < _W8A8_CLUSTER_TILES and k <= _W8A8_CLUSTER_SPLITS * _W8A8_CLUSTER_ROWS:
        split_rows = -(-k // _W8A8_CLUSTER_SPLITS)
        split_rows = -(-split_rows // _QMM_TILE_ROWS) * _QMM_TILE_ROWS
    splits = -(-k // split_rows)
    cluster = splits > 1 and tiles < _W8A8_CLUSTER_TILES and (
        k <= _W8A8_CLUSTER_SPLITS * _W8A8_CLUSTER_ROWS)
    return W8a8Geometry(m_tiles, tiles, splits, split_rows, cluster)
