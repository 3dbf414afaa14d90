"""The host-side launch geometry of the split-S attention kernel, of the
one-launch qmm (weight-only and w8a8 bodies), of the one-launch float GEMV
wmm and of the vocab-split sampler, on the CPU: plain Python that decides how the kernels in
``zig_gpt2_tpu_torch/ops/csrc`` cut their work. Shapes only (never
``length``), exact cover of the rows, the limits the kernels check, and the
block counts the kernels' source notes give for the GPT-2 serving shapes.
"""

import inspect
import re
from pathlib import Path

import pytest
import torch

from zig_gpt2_tpu_torch.ops import _build
from zig_gpt2_tpu_torch.ops import attention as att
from zig_gpt2_tpu_torch.ops import sampling_kernel as sk
from zig_gpt2_tpu_torch.quant import kernels as qk

CSRC = Path(_build.__file__).resolve().parent / "csrc"

ATTN_SHAPES = [(B, H, S) for B in (1, 2, 4, 8, 16, 64) for H in (1, 3, 6, 12, 13, 25)
               for S in (1, 17, 64, 150, 257, 1024, 1025, 4096)]


def test_geometry_takes_shapes_only():
    assert list(inspect.signature(att.attention_splits).parameters) == ["B", "H", "S"]
    assert list(inspect.signature(qk.qmm_geometry).parameters) == ["rows", "k", "n", "int4",
                                                                  "dtype"]


@pytest.mark.parametrize("B,H,S", ATTN_SHAPES[::7] + [(1, 25, 1024), (16, 13, 1025)])
def test_attention_splits_cover_the_rows_once(B, H, S):
    splits, chunk = att.attention_splits(B, H, S)
    assert splits >= 1 and chunk >= -(-att._ATTN_SPAN // att._ATTN_MAX_SPLITS)
    covered = [i for s in range(splits) for i in range(s * chunk, min((s + 1) * chunk, S))]
    assert covered == list(range(S))  # every row once, in order, no split empty
    assert (splits - 1) * chunk < S <= splits * chunk


def test_attention_splits_is_a_function_of_the_shapes():
    for shape in ATTN_SHAPES:
        assert att.attention_splits(*shape) == att.attention_splits(*shape)


@pytest.mark.parametrize("B,H", sorted({(B, H) for B, H, _ in ATTN_SHAPES}))
def test_attention_chunk_does_not_depend_on_the_cache_rows(B, H):
    """A lane's rows fall into the same chunks in a cache of any S (the
    kernel then gives the same bits), and a GPT-2 cache gets the fewest
    splits that put a block on every SM."""
    chunks = {att.attention_splits(B, H, S)[1] for S in (1, 17, 257, 1024, 1025, 4096)}
    assert len(chunks) == 1
    splits = att.attention_splits(B, H, att._ATTN_SPAN)[0]
    assert splits <= att._ATTN_MAX_SPLITS
    assert splits == att._ATTN_MAX_SPLITS or B * H * splits >= att._ATTN_MIN_BLOCKS
    assert splits == 1 or B * H * (splits // 2) < att._ATTN_MIN_BLOCKS


@pytest.mark.parametrize("B,H,S,splits,chunk,blocks", [
    (1, 25, 1024, 8, 136, 200),    # 1.5B engine, unpacked
    (1, 13, 1024, 16, 68, 208),    # 1.5B engine, packed (phantom head)
    (1, 12, 1024, 16, 68, 192),    # 124M engine, unpacked
    (1, 6, 1024, 16, 68, 96),      # 124M engine, packed
    (16, 25, 1025, 1, 1088, 400),  # 1.5B batcher ring, unpacked: fills the card
    (16, 13, 1025, 1, 1088, 208),  # packed
    (16, 25, 257, 1, 1088, 400),   # the served batcher's R = 257
    (16, 6, 1025, 2, 544, 192),    # 124M batcher, packed: 96 blocks are too few
    (8, 12, 257, 1, 544, 96),      # 124M batcher, B=8: one split of its 257 rows
])
def test_attention_splits_on_the_serving_shapes(B, H, S, splits, chunk, blocks):
    assert att.attention_splits(B, H, S) == (splits, chunk)
    assert B * H * splits == blocks


def test_attention_splits_rejects_empty_shapes():
    with pytest.raises(ValueError):
        att.attention_splits(1, 0, 1024)
    with pytest.raises(ValueError):
        att.attention_splits(1, 2, 0)


def test_attention_tile_constants_match_the_kernel():
    src = (CSRC / "decode_attention.cu").read_text()
    assert re.search(r"constexpr int kWarps = (\d+);", src).group(1) == "8"
    assert "__launch_bounds__(kThreads, 2)" in src
    assert "const dim3 grid(a.splits, a.H, a.B);" in src


QMM_SHAPES = [(rows, k, n, int4, dtype)
              for rows in (1, 2, 4, 15, 16, 17, 40, 64, 65, 256)
              for k, n in ((64, 8), (96, 150), (640, 1000), (1600, 1600), (1600, 6400),
                           (6400, 1600), (1600, 50257))
              for int4 in (False, True)
              for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("rows,k,n,int4,dtype", QMM_SHAPES[::9])
def test_qmm_geometry_covers_k_once(rows, k, n, int4, dtype):
    geo = qk.qmm_geometry(rows, k, n, int4, dtype)
    p = k // 2 if int4 else k
    assert geo.splits >= 1 and geo.split_rows % qk._QMM_TILE_ROWS == 0
    assert (geo.splits - 1) * geo.split_rows < p <= geo.splits * geo.split_rows
    covered = [i for s in range(geo.splits)
               for i in range(s * geo.split_rows, min((s + 1) * geo.split_rows, p))]
    assert covered == list(range(p))
    assert geo.tiles == -(-rows // geo.row_tile) * -(-n // qk._QMM_COLS)
    assert geo.splits <= 65535  # gridDim.z


@pytest.mark.parametrize("rows,k,n,int4,dtype", QMM_SHAPES[::5])
def test_qmm_geometry_fits_the_body(rows, k, n, int4, dtype):
    """The body follows rows and dtype, and a split's x fits the body's
    shared memory as csrc/qmm.cu computes it."""
    geo = qk.qmm_geometry(rows, k, n, int4, dtype)
    if dtype == torch.bfloat16 and rows > 1:
        assert geo.row_tile == (16 if rows <= 16 else 64)  # the tensor cores
        x_bytes = geo.row_tile * ((2 if int4 else 1) * geo.split_rows + 8) * 2
        budget = qk._QMM_X_BYTES_WIDE if geo.row_tile == 64 else qk._QMM_X_BYTES
    else:
        assert geo.row_tile == (1 if rows == 1 else 4)  # the CUDA cores
        x_bytes = geo.row_tile * (2 if int4 else 1) * geo.split_rows * 4
        budget = qk._QMM_X_BYTES
    assert x_bytes <= budget


@pytest.mark.parametrize("k,n,int4,rows,row_tile,splits,blocks", [
    (1600, 1600, True, 1, 1, 13, 169),      # attn Q/K/V/c_proj, B=1
    (1600, 6400, True, 1, 1, 5, 250),       # c_fc
    (6400, 1600, True, 1, 1, 17, 221),      # MLP c_proj
    (1600, 50257, False, 1, 1, 1, 393),     # INT8 lm_head: enough columns already
    (1600, 1600, True, 16, 16, 7, 91),      # the batcher's 16 rows, one pass
    (1600, 6400, True, 16, 16, 5, 250),
    (6400, 1600, True, 16, 16, 17, 221),
])
def test_qmm_geometry_on_the_serving_shapes(k, n, int4, rows, row_tile, splits, blocks):
    geo = qk.qmm_geometry(rows, k, n, int4, torch.bfloat16)
    assert (geo.row_tile, geo.splits, geo.tiles * geo.splits) == (row_tile, splits, blocks)


def test_qmm_geometry_is_a_function_of_the_shapes():
    for shape in QMM_SHAPES:
        assert qk.qmm_geometry(*shape) == qk.qmm_geometry(*shape)
    with pytest.raises(ValueError):
        qk.qmm_geometry(0, 64, 8, False, torch.float32)


def test_qmm_constants_match_the_kernel():
    src = (CSRC / "qmm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kKT") == qk._QMM_TILE_ROWS
    assert const("kNT") == qk._QMM_COLS
    assert const("kXBytes") == qk._QMM_X_BYTES
    assert const("kXBytesWide") == qk._QMM_X_BYTES_WIDE
    assert "qmm_reduce_kernel" not in src  # the weight-only body is one launch


def _c_params(src: str, name: str) -> int:
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    return len(m.group(1).split(","))


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_entry_points(name):
    src = "\n".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    assert _c_params(src, name) == len(_build.SIGNATURES[name])


def test_build_digest_covers_the_shared_header(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text("// a")
    (tmp_path / "h.cuh").write_text("// h1")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest([tmp_path / "a.cu"])
    (tmp_path / "h.cuh").write_text("// h2")
    assert _build._digest([tmp_path / "a.cu"]) != first


def test_tickets_grow_and_keep_the_old_tensors(monkeypatch):
    monkeypatch.setattr(_build, "_TICKETS", {})
    small = _build.tickets("cpu", 10)
    assert small.dtype == torch.int32 and small.numel() >= 10 and not small.any()
    assert _build.tickets("cpu", 5) is small
    big = _build.tickets("cpu", small.numel() + 1)
    assert big.numel() > small.numel() and not big.any()
    assert _build._TICKETS[torch.device("cpu")] == [small, big]


# --- the sampler's vocab split and the w8a8 body's K split --------------------

SAMPLER_SHAPES = [(B, V) for B in (1, 2, 4, 16, 17, 64, 65535)
                  for V in (1, 7, 100, 128, 129, 1000, 50257, 50304)]


def test_sampler_and_w8a8_geometry_take_shapes_only():
    assert list(inspect.signature(sk.sampler_geometry).parameters) == ["B", "V"]
    assert list(inspect.signature(qk.w8a8_geometry).parameters) == ["rows", "k", "n"]


@pytest.mark.parametrize("B,V", SAMPLER_SHAPES)
def test_sampler_geometry_covers_the_vocab_once(B, V):
    splits, chunk = sk.sampler_geometry(B, V)
    assert splits >= 1 and chunk % sk._SAMPLER_THREADS == 0
    covered = [j for s in range(splits) for j in range(s * chunk, min((s + 1) * chunk, V))]
    assert covered == list(range(V))  # every id once, in order, no split empty
    assert (splits - 1) * chunk < V <= splits * chunk
    assert B * splits <= max(B, sk._SAMPLER_SLOTS + B)  # about two blocks per SM, at most


def test_sampler_geometry_is_a_function_of_the_shapes():
    for shape in SAMPLER_SHAPES:
        assert sk.sampler_geometry(*shape) == sk.sampler_geometry(*shape)
    for bad in ((0, 10), (1, 0)):
        with pytest.raises(ValueError):
            sk.sampler_geometry(*bad)


@pytest.mark.parametrize("B,V,splits,chunk", [
    (1, 50257, 197, 256),    # the engines: ~200 blocks where one ran before
    (4, 50257, 66, 768),
    (16, 50257, 17, 3072),   # the sampled batchers
    (17, 50257, 16, 3200),
    (1, 7, 1, 128),          # a small vocab: one block, no combine
])
def test_sampler_geometry_on_the_serving_shapes(B, V, splits, chunk):
    assert sk.sampler_geometry(B, V) == (splits, chunk)


def test_sampler_constants_match_the_kernel():
    src = (CSRC / "sampling.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == \
        sk._SAMPLER_THREADS
    assert "dim3(splits, B)" in src and "zg2::last_to_arrive(tickets + b, splits)" in src


W8A8_SHAPES = [(rows, k, n) for rows in (1, 2, 15, 16, 17, 32, 33, 64)
               for k, n in ((64, 8), (100, 150), (1000, 200), (1600, 1664), (1664, 1600),
                            (1600, 6400), (6400, 1600), (1600, 50257))]


@pytest.mark.parametrize("rows,k,n", W8A8_SHAPES[::3])
def test_w8a8_geometry_covers_k_once_and_fits_the_body(rows, k, n):
    geo = qk.w8a8_geometry(rows, k, n)
    assert geo.split_rows % qk._QMM_TILE_ROWS == 0
    covered = [i for s in range(geo.splits)
               for i in range(s * geo.split_rows, min((s + 1) * geo.split_rows, k))]
    assert covered == list(range(k))
    assert geo.tiles == -(-n // qk._QMM_COLS) and geo.splits <= 65535  # gridDim.y
    assert geo.m_tiles == (1 if rows <= 16 else 2 if rows <= 32 else 4)
    assert rows <= 16 * geo.m_tiles
    if geo.cluster:  # every split of a column tile in one portable cluster
        assert 2 <= geo.splits <= qk._W8A8_CLUSTER_SPLITS
        assert geo.tiles < qk._W8A8_CLUSTER_TILES
    x_bytes = 16 * geo.m_tiles * (geo.split_rows + 16)  # csrc/qmm.cu launch_w8a8
    assert x_bytes <= (qk._W8A8_X_BYTES if geo.m_tiles == 1 else qk._W8A8_X_BYTES_WIDE)


def test_w8a8_geometry_is_a_function_of_the_shapes():
    for shape in W8A8_SHAPES:
        assert qk.w8a8_geometry(*shape) == qk.w8a8_geometry(*shape)
    for bad in ((0, 64, 8), (65, 64, 8), (1, 0, 8), (1, 64, 0)):
        with pytest.raises(ValueError):
            qk.w8a8_geometry(*bad)


@pytest.mark.parametrize("k,n,rows,splits,blocks,cluster", [
    (1600, 1664, 1, 7, 91, True),      # attn Q/K/V with the phantom head, B=1
    (1664, 1600, 1, 7, 91, True),      # attn c_proj
    (1600, 6400, 1, 5, 250, False),    # c_fc: 50 column tiles, ticket
    (6400, 1600, 1, 20, 260, False),   # MLP c_proj: long K, ticket
    (1600, 50257, 1, 1, 393, False),   # INT8 lm_head: enough columns already
    (1600, 1664, 16, 7, 91, True),     # the batcher's 16 rows: the same blocks, one pass
    (6400, 1600, 16, 20, 260, False),
    (1600, 50257, 16, 1, 393, False),
])
def test_w8a8_geometry_on_the_serving_shapes(k, n, rows, splits, blocks, cluster):
    geo = qk.w8a8_geometry(rows, k, n)
    assert (geo.splits, geo.tiles * geo.splits, geo.cluster) == (splits, blocks, cluster)


def test_w8a8_constants_match_the_kernel():
    src = (CSRC / "qmm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kW8XBytes") == qk._W8A8_X_BYTES
    assert const("kW8XBytesWide") == qk._W8A8_X_BYTES_WIDE
    assert "return rows <= 16 ? 1 : rows <= 32 ? 2 : 4;" in src  # w8a8_m_tiles
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert qk._W8A8_CLUSTER_SPLITS == 8  # the portable cluster size the entry point takes
    assert "(cluster && (splits < 2 || splits > 8))" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "qmm_w8a8_reduce_kernel" not in src  # the w8a8 body is one launch too


# --- the float GEMV wmm: one launch, K split added in a cluster or by ticket ---

_F32, _BF16 = torch.float32, torch.bfloat16
WMM_ROWS = (1, 2, 7, 8, 15, 16, 17, 63, 64, 65, 255, 256)
WMM_SHAPES = [(rows, k, n, xd, wd) for rows in WMM_ROWS
              for k, n in ((100, 150), (768, 768), (768, 3072), (3072, 768), (3072, 770),
                           (1600, 4800), (6400, 1600), (64, 8))
              for xd in (_F32, _BF16) for wd in (_F32, _BF16)]


def _wmm_smem(geo, wdtype) -> int:
    """Dynamic shared memory of a wmm block, as csrc/wmm.cu's launch()
    computes it: the tensor cores' ring (32 staged rows of 128 columns plus
    16 bytes, as many stages as fit 104448 bytes) and x, or the tile's sums
    if larger; the CUDA cores' x, per-warp sums and tile."""
    size = 4 if wdtype == _F32 else 2
    if geo.row_tile >= 16:
        stage = 32 * (geo.col_tile * size + 16)
        stages = min(-(-geo.split_rows // 32), 104448 // stage)
        x_bytes = geo.row_tile * (geo.split_rows + 8) * 2
        return max(stages * stage + x_bytes, geo.row_tile * geo.col_tile * 4)
    return geo.row_tile * geo.split_rows * 4 + 9 * geo.row_tile * geo.col_tile * 4


def _wmm_cap(geo) -> int:
    """The longest range whose x fits the body's shared memory, in whole
    32-row tiles."""
    if geo.row_tile >= 16:
        budget = qk._WMM_X_BYTES_WIDE if geo.row_tile == 64 else qk._WMM_X_BYTES
        return (budget // (2 * geo.row_tile) - 8) // 32 * 32
    return qk._WMM_X_BYTES // (4 * geo.row_tile) // 32 * 32


def test_wmm_geometry_takes_shapes_only():
    assert list(inspect.signature(qk.wmm_geometry).parameters) == ["rows", "k", "n", "xdtype",
                                                                  "wdtype"]


@pytest.mark.parametrize("rows,k,n,xdtype,wdtype", WMM_SHAPES[::5])
def test_wmm_geometry_covers_k_once(rows, k, n, xdtype, wdtype):
    geo = qk.wmm_geometry(rows, k, n, xdtype, wdtype)
    assert geo.splits >= 1 and geo.split_rows % qk._WMM_TILE_ROWS == 0
    assert (geo.splits - 1) * geo.split_rows < k <= geo.splits * geo.split_rows
    covered = [i for s in range(geo.splits)
               for i in range(s * geo.split_rows, min((s + 1) * geo.split_rows, k))]
    assert covered == list(range(k))  # every weight row once, in order, no split empty
    assert geo.splits <= 65535 and -(-n // geo.col_tile) <= 65535  # gridDim.y, gridDim.z


@pytest.mark.parametrize("rows,k,n,xdtype,wdtype", WMM_SHAPES[2::5])
def test_wmm_geometry_fits_the_body(rows, k, n, xdtype, wdtype):
    """The body follows rows and x's dtype, and its column tile the body; a
    split's x fits the body's budget and the whole block the card's 227 KB;
    a cluster holds 2 to 16 splits."""
    geo = qk.wmm_geometry(rows, k, n, xdtype, wdtype)
    if xdtype == _BF16 and rows > 1:
        assert geo.row_tile == (16 if rows <= 16 else 64)  # the tensor cores
        assert geo.col_tile == qk._WMM_MMA_COLS == 128
        x_bytes = geo.row_tile * (geo.split_rows + 8) * 2
        budget = qk._WMM_X_BYTES_WIDE if geo.row_tile == 64 else qk._WMM_X_BYTES
    else:
        assert geo.row_tile == (1 if rows == 1 else 4)  # the CUDA cores
        assert geo.col_tile == qk._WMM_SIMT_COLS == 64
        x_bytes = geo.row_tile * geo.split_rows * 4
        budget = qk._WMM_X_BYTES
    assert x_bytes <= budget and geo.split_rows <= _wmm_cap(geo)
    assert _wmm_smem(geo, wdtype) <= 232448
    assert geo.cluster == (1 < geo.splits <= qk._WMM_CLUSTER_SPLITS == 16)


@pytest.mark.parametrize("rows,k,n,xdtype,wdtype", WMM_SHAPES[4::9])
def test_wmm_geometry_aims_at_its_block_count(rows, k, n, xdtype, wdtype):
    """A split holds the rows that give the body's block count, or the
    body's least weight per block if that is more (at most K), rounded up to
    whole tiles; or, where that would take more splits than one cluster
    holds, the fewest rows that make one cluster; the x budget caps it, and
    only the cap leaves more than one cluster's splits (the ticket)."""
    geo = qk.wmm_geometry(rows, k, n, xdtype, wdtype)
    mma = geo.row_tile >= 16
    blocks = qk._WMM_BLOCKS_MMA if mma else qk._WMM_BLOCKS_SIMT
    want = -(-blocks // (-(-rows // geo.row_tile) * -(-n // geo.col_tile)))
    min_bytes = qk._WMM_MIN_BYTES_MMA if mma else qk._WMM_MIN_BYTES_SIMT
    least = min_bytes // (geo.col_tile * (4 if wdtype == _F32 else 2))
    cap = _wmm_cap(geo)
    rows_for = min(max(-(-k // want), least), k)
    split_rows = -(-rows_for // 32) * 32
    if -(-k // split_rows) > qk._WMM_CLUSTER_SPLITS:  # the fewest rows for one cluster
        split_rows = max(split_rows, -(-k // (32 * qk._WMM_CLUSTER_SPLITS)) * 32)
    assert geo.split_rows == min(split_rows, cap)
    assert geo.splits <= qk._WMM_CLUSTER_SPLITS or geo.split_rows == cap


def test_wmm_geometry_is_a_function_of_the_shapes():
    for shape in WMM_SHAPES:
        assert qk.wmm_geometry(*shape) == qk.wmm_geometry(*shape)
    for bad in ((0, 64, 8), (257, 64, 8), (1, 0, 8), (1, 64, 0)):
        with pytest.raises(ValueError):
            qk.wmm_geometry(*bad, _F32, _F32)


# GPT-2 124M's decode linears (Q/K/V and attn c_proj 768x768, c_fc 768x3072,
# MLP c_proj 3072x768) at the served row counts, x and w of one dtype:
# (k, n, rows, dtype, row_tile, col_tile, splits, split_rows, blocks,
# cluster). The row counts 1 and 8 were timed in a sweep of geometries on the
# H100 (PERF.md, PR 8).
WMM_SERVING = [
    (768, 768, 1, _F32, 1, 64, 8, 96, 96, True),
    (768, 3072, 1, _F32, 1, 64, 2, 384, 96, True),
    (3072, 768, 1, _F32, 1, 64, 8, 384, 96, True),
    (768, 768, 8, _F32, 4, 64, 4, 192, 96, True),       # the f32 batcher's B=8: two row tiles
    (768, 3072, 8, _F32, 4, 64, 1, 768, 96, False),     # one split: no combine
    (3072, 768, 8, _F32, 4, 64, 4, 768, 96, True),
    (768, 768, 16, _F32, 4, 64, 2, 384, 96, True),
    (768, 3072, 16, _F32, 4, 64, 1, 768, 192, False),
    (3072, 768, 16, _F32, 4, 64, 2, 1536, 96, True),
    (768, 768, 64, _F32, 4, 64, 1, 768, 192, False),
    (768, 3072, 64, _F32, 4, 64, 1, 768, 768, False),
    (3072, 768, 64, _F32, 4, 64, 2, 2048, 384, True),   # the x budget caps the range
    (768, 768, 256, _F32, 4, 64, 1, 768, 768, False),
    (768, 3072, 256, _F32, 4, 64, 1, 768, 3072, False),
    (3072, 768, 256, _F32, 4, 64, 2, 2048, 1536, True),
    (768, 768, 1, _BF16, 1, 64, 4, 192, 48, True),      # 24 KB of weight per block, at least
    (768, 3072, 1, _BF16, 1, 64, 2, 384, 96, True),
    (3072, 768, 1, _BF16, 1, 64, 8, 384, 96, True),
    (768, 768, 8, _BF16, 16, 128, 12, 64, 72, True),    # the bf16 batcher's B=8: one padded tile
    (768, 3072, 8, _BF16, 16, 128, 8, 96, 192, True),
    (3072, 768, 8, _BF16, 16, 128, 16, 192, 96, True),  # one 16-block cluster
    (768, 768, 16, _BF16, 16, 128, 12, 64, 72, True),
    (768, 3072, 16, _BF16, 16, 128, 8, 96, 192, True),
    (3072, 768, 16, _BF16, 16, 128, 16, 192, 96, True),
    (768, 768, 64, _BF16, 64, 128, 12, 64, 72, True),   # every row against one weight pass
    (768, 3072, 64, _BF16, 64, 128, 8, 96, 192, True),
    (3072, 768, 64, _BF16, 64, 128, 16, 192, 96, True),
    (768, 768, 256, _BF16, 64, 128, 8, 96, 192, True),  # four row blocks per weight tile
    (768, 3072, 256, _BF16, 64, 128, 2, 384, 192, True),
    (3072, 768, 256, _BF16, 64, 128, 8, 384, 192, True),
]


@pytest.mark.parametrize("k,n,rows,dtype,row_tile,col_tile,splits,split_rows,blocks,cluster",
                         WMM_SERVING)
def test_wmm_geometry_on_the_serving_shapes(k, n, rows, dtype, row_tile, col_tile, splits,
                                            split_rows, blocks, cluster):
    geo = qk.wmm_geometry(rows, k, n, dtype, dtype)
    assert (geo.row_tile, geo.col_tile, geo.splits, geo.split_rows, geo.cluster) == (
        row_tile, col_tile, splits, split_rows, cluster)
    assert -(-rows // geo.row_tile) * -(-n // geo.col_tile) * geo.splits == blocks


def test_wmm_geometry_takes_the_ticket_beyond_one_cluster():
    """A K longer than 16 ranges of the x budget (64 bf16 rows: 480 rows
    per range) splits into more ranges than one cluster holds, and the last
    block of each output tile adds them."""
    geo = qk.wmm_geometry(64, 8192, 768, _BF16, _BF16)
    assert (geo.splits, geo.split_rows, geo.cluster) == (18, 480, False)
    assert qk.wmm_geometry(1, 8192, 768, _F32, _F32).cluster  # one row: a long range fits


def test_wmm_constants_match_the_kernel():
    src = (CSRC / "wmm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSimtCols") == qk._WMM_SIMT_COLS
    assert const("kMmaCols") == qk._WMM_MMA_COLS
    assert const("kKT") == qk._WMM_TILE_ROWS
    assert const("kRingBytes") == 104448  # _wmm_smem above
    assert const("kXBytes") == qk._WMM_X_BYTES
    assert const("kXBytesWide") == qk._WMM_X_BYTES_WIDE
    assert const("kMaxCluster") == qk._WMM_CLUSTER_SPLITS
    assert "if (bf16_x && rows > 1) return rows <= 16 ? 16 : 64;" in src  # row_tile
    assert "(cluster && (splits < 2 || splits > kMaxCluster))" in src
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "const dim3 grid((a.rows + rt - 1) / rt, splits, (a.N + nt - 1) / nt);" in src
    # One launch per call: no second pass, and the host's split helper is gone.
    assert "wmm_reduce_kernel" not in src
    assert not hasattr(qk, "_k_splits")
