// Float-weight decode GEMV on Hopper (sm_90a).
//
// Replaces: zig_gpt2_tpu/quant/kernels.py, wmm (body _wmm_kernel), per-layer
// form (the caller passes the layer's view w[idx]). Same contract: x (rows,
// K) f32 or bf16, rows <= 256; w (K, N) f32 or bf16. Output (rows, N) f32:
//
//   y[r, n] = sum_k x[r, k] * round_x(w[k, n])
//
// round_x rounds the weight to the activation dtype (an f32 weight under a
// bf16 x is rounded to bf16 first, as w.astype(x.dtype) does); products and
// sums are f32.
//
// Bound on the H100: device-memory bytes. A decode call (rows = 1) reads
// each weight once and does 2 flops per weight: 0.5 flops per byte for f32
// weights, 1 for bf16, far below the ~20 where the f32 units would become
// the limit (and the ~295 of the bf16 tensor cores). At GPT-2 124M a
// layer's six block linears are 7.08 M weights, 28.3 MB in f32: 72 calls
// per B=1 decode step move 340 MB, 0.10 ms at 3.35 TB/s (0.05 ms in bf16).
// A 768x768 f32 weight (2.36 MB) is less than one latency-bandwidth product
// of the card (~3.4 MB), so a call nears its bound only if nearly all of
// its bytes are requested at once.
//
// Design against that bound (quant/kernels.py wmm_geometry picks every
// size below from the shapes alone):
// - One launch per call. The grid is (row tiles, K splits, column tiles of
//   64 or 128): about 96 blocks on the CUDA cores and 192 on the tensor
//   cores at the GPT-2 124M shapes, each with at least 24 or 16 KB of
//   weight (the best of a sweep, tools/wmm_sweep.py). The splits of an
//   output tile are added in split order, so two calls give the same bits:
//   up to kMaxCluster (16) splits form one thread-block cluster whose blocks
//   add the tile's sums from every block's shared memory (no partial sums
//   in device memory, no ticket; every 124M shape), more splits (K beyond
//   16 x the x budget) write tile-contiguous partial sums and the last
//   block to take the tile's ticket (zg2::last_to_arrive) adds them. The
//   PR 5 design's second (reduce) launch is gone: 72 kernels per 124M
//   decode step, not 144.
// - One row, or f32 x at any row count: CUDA cores, f32 FMAs (no TF32, which
//   would break the 1e-4 gate), rows tiled by 1, else 4. Each lane owns 4
//   neighbouring f32 or 8 bf16 columns of a 64-column tile and a k-slice of
//   the block's rows, and reads each of its rows with one 16-byte load
//   straight into registers, 16 rows in flight (64 KB per block: the whole
//   range at one row), the first batch issued before x is staged in shared
//   memory; a row piece that does not start on 16 bytes (N % 4 != 0 for
//   f32, N % 8 != 0 for bf16) is read one element at a time, picked by the
//   address. The slices of a warp are added by shuffle, the warps in warp
//   order. (A cp.async ring of 32-row tiles in shared memory, as qmm.cu's,
//   was slower at every 124M shape on the H100 in trials, and 8-row f32
//   tiles no faster than 4.)
// - Two or more rows with bf16 x: tensor cores, mma.sync.m16n8k16 (bf16 in,
//   f32 sums), 128-column tiles. Weight tiles of 32 rows reach shared memory
//   by 16-byte cp.async in a ring of about 100 KB, so a block's whole K range
//   (up to 11 tiles of bf16 weight, 5 of f32; the served ranges are 2 to 6)
//   is in flight before its first product; rows are staged 16 bytes longer than the tile's (a row that
//   starts off 16 bytes is copied as the aligned pieces that cover it and
//   read at its offset), which also keeps the fragment loads free of bank
//   conflicts. Warp w owns 16 of the tile's columns and builds its B
//   fragments as qmm.cu's tensor-core body does (rows 2 tq, 2 tq + 1,
//   2 tq + 8, 2 tq + 9 of column g); an f32 weight is rounded to bf16 on the
//   way (round_x). Every 16-row A tile of the block's rows (16, or 64 up to
//   64 rows: the batcher's B=8 is one padded tile) goes against one pass
//   over each weight tile. Above 64 rows the row blocks of one weight tile
//   are neighbours in launch order (gridDim.x), so the weight comes from L2
//   after the first. bf16 products are exact in f32; only the order of the
//   f32 sums differs from the plain version.
// - x of the block's rows over its K range is read into shared memory once,
//   after the first weight loads are issued.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;         // 8 warps
constexpr int kKT = 32;               // weight rows per tile
constexpr int kRingBytes = 104448;    // the tensor cores' ring: 12 stages of 32 x 272 bytes
constexpr int kXBytes = 32768;        // x in shared memory: CUDA cores, 16-row mma
constexpr int kXBytesWide = 65536;    // 64-row mma
constexpr int kMaxCluster = 16;       // splits of one cluster (above 8: non-portable)
constexpr int kSimtCols = 64;         // output columns per block: CUDA cores
constexpr int kMmaCols = 128;         // ... tensor cores
constexpr int kMaxSmem = kRingBytes + kXBytesWide;
using bf16 = __nv_bfloat16;

// A staged weight row: the tile's NT columns plus 16 bytes, so that a row
// starting off 16 bytes still fits; kPieces 16-byte copies cover it. The
// ring has as many stages as fit kRingBytes (12 of 128 bf16 columns, 6 of
// 128 f32 columns).
template <typename TW, int NT>
struct Staged {
  static constexpr int kRowBytes = NT * (int)sizeof(TW) + 16;
  static constexpr int kPieces = kRowBytes / 16;
  static constexpr int kStageBytes = kKT * kRowBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
};

// Every pointer and size of one call. split_rows: weight rows per K split,
// a multiple of kKT; splits is gridDim.y. part: (tiles, splits, row
// tile x column tile) f32 and tickets: one int32 at 0 per output tile (row
// tile x column tile), used only without a cluster and with more than one
// split.
struct WArgs {
  const void* x;
  const void* w;
  float* part;
  int* tickets;
  float* out;
  int rows, K, N, split_rows;
  int cluster;  // the splits of an output tile form one cluster
};

// Stages a block allocates: its range's tiles, at most the ring's.
template <typename TW, int NT>
__host__ __device__ __forceinline__ int ring_stages(int split_rows) {
  const int t = (split_rows + kKT - 1) / kKT;
  return t < Staged<TW, NT>::kStages ? t : Staged<TW, NT>::kStages;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The ring of weight tiles of one block: columns [c0, c0 + NT), rows
// [k_begin, k_end) in tiles of kKT. Holds its sizes by value (a reference
// to the kernel's parameter would put it in local memory).
template <typename TW, int NT>
struct Ring {
  using S = Staged<TW, NT>;
  const unsigned char* w;
  unsigned char* smem;
  int N, c0, col_bytes, k_begin, k_end, ntiles;

  __device__ __forceinline__ Ring(const WArgs& a, unsigned char* s, int col0, int split)
      : w((const unsigned char*)a.w), smem(s), N(a.N), c0(col0) {
    col_bytes = min(NT, N - c0) * (int)sizeof(TW);
    k_begin = split * a.split_rows;
    k_end = min(a.K, k_begin + a.split_rows);
    ntiles = (k_end - k_begin + kKT - 1) / kKT;
  }
  __device__ __forceinline__ const unsigned char* row(int k) const {
    return w + ((int64_t)k * N + c0) * (int64_t)sizeof(TW);
  }
  __device__ __forceinline__ unsigned char* stage(int t) const {
    return smem + (t % S::kStages) * S::kStageBytes;
  }
  // Byte offset of weight row k's first column in its staged row.
  __device__ __forceinline__ int shift(int k) const { return (int)((uintptr_t)row(k) & 15); }

  // Copy tile t into its stage; rows past the range and pieces past the
  // row's columns are zero-filled. An empty group past the last tile keeps
  // the wait counts uniform.
  __device__ __forceinline__ void issue(int t) const {
    if (t < ntiles) {
      const int k0 = k_begin + t * kKT;
      const int nr = min(kKT, k_end - k0);
      unsigned char* st = stage(t);
      const unsigned char* safe = (const unsigned char*)((uintptr_t)w & ~(uintptr_t)15);
      for (int c = threadIdx.x; c < kKT * S::kPieces; c += kThreads) {
        const int r = c / S::kPieces, j = c - r * S::kPieces;
        const bool in = r < nr;
        const unsigned char* src = in ? row(k0 + r) : safe;
        const int sh = (int)((uintptr_t)src & 15);
        // Each piece copied holds a byte of the row, so it lies on a mapped page.
        const bool ok = in && 16 * j < sh + col_bytes;
        zg2::cp_async16(st + r * S::kRowBytes + 16 * j, ok ? src - sh + 16 * j : safe, ok);
      }
    }
    zg2::cp_async_commit();
  }

  // Column col of staged row r (weight row k) as a float.
  __device__ __forceinline__ float elem(const unsigned char* st, int r, int k, int col) const {
    return to_f32(*reinterpret_cast<const TW*>(st + r * S::kRowBytes + shift(k) +
                                               col * (int)sizeof(TW)));
  }
};

// The E = 16 / sizeof(TW) weights in a 16-byte piece as floats, rounded to
// the activation dtype TX (round_x: only an f32 weight under bf16 x changes).
template <typename TX, typename TW>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  if constexpr (std::is_same<TW, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(u[i]);
    if constexpr (std::is_same<TX, bf16>::value) {
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const __nv_bfloat162 r = __floats2bfloat162_rn(f[i], f[i + 1]);
        f[i] = __low2float(r);
        f[i + 1] = __high2float(r);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
}

// x rows [r0, r0 + nrows) over [k_begin, k_end) into xs (row stride ld) as
// U (f32, or bf16 for the tensor cores); zeros past the rows and the range.
// Loads go out kBatch at a time per thread, so that their latencies overlap.
template <typename T, typename U>
__device__ __forceinline__ void stage_x(const WArgs& a, U* xs, int ld, int r0, int nrows,
                                        int k_begin, int k_end) {
  constexpr int kBatch = 4;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  const T* x = static_cast<const T*>(a.x);
  const int width = a.split_rows;
  // 16 bytes at a time when every row and range starts on 16 bytes (K a
  // multiple of E; split_rows is a multiple of 32), else one element.
  const bool vec = ((uintptr_t)x & 15) == 0 && a.K % E == 0;
  const int step = vec ? E : 1;
  const int total = nrows * width / step;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    uint4 v[kBatch];  // 16 raw bytes, or one f32 in .x
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i * step / width, j = i * step - r * width;
      const int k = k_begin + j;
      // A 16-byte piece is wholly inside or wholly past the range: k_end is
      // K or a multiple of 32, and K is a multiple of E.
      const bool ok = i < total && r0 + r < a.rows && k < k_end;
      const int64_t at = (int64_t)(r0 + r) * a.K + k;
      v[u] = make_uint4(0, 0, 0, 0);
      if (vec && ok)
        v[u] = __ldg(reinterpret_cast<const uint4*>(x + at));
      else if (ok)
        v[u].x = __float_as_uint(to_f32(x[at]));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= total) break;
      const int r = i * step / width, j = i * step - r * width;
      const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        if (k >= step) break;
        const float f = vec ? to_f32(e[k]) : __uint_as_float(v[u].x);
        if constexpr (std::is_same<U, float>::value)
          xs[r * ld + j + k] = f;
        else
          xs[r * ld + j + k] = __float2bfloat16(f);  // exact: x is bf16
      }
    }
  }
}

// The block's sums for its output tile, rows [r0, r0 + nrows) x columns
// [c0, c0 + NT), in shared memory (row stride NT): written as they are
// with one split, else added over the splits in split order, through
// distributed shared memory in a cluster, or by the last block to take the
// tile's ticket. Call from every thread of the block.
template <int NT>
__device__ __forceinline__ void finish(const WArgs& a, float* tile, int nrows, int r0, int c0) {
  const int splits = gridDim.y;
  const int live = min(nrows, a.rows - r0) * NT;  // the tile's outputs with a row
  if (splits == 1) {
    for (int o = threadIdx.x; o < live; o += kThreads) {
      const int n = c0 + o % NT;
      if (n < a.N) a.out[(int64_t)(r0 + o / NT) * a.N + n] = tile[o];
    }
    return;
  }
  if (a.cluster) {
    // Block rank q of the cluster is split q. Each block adds every rank's
    // sums for its share of the outputs, all loads in flight first; the
    // second barrier keeps every block's sums alive until they are read.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int o = threadIdx.x + blockIdx.y * kThreads; o < live; o += splits * kThreads) {
      float v[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < splits) v[q] = *cluster.map_shared_rank(tile + o, q);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < splits) s += v[q];
      const int n = c0 + o % NT;
      if (n < a.N) a.out[(int64_t)(r0 + o / NT) * a.N + n] = s;
    }
    cluster.sync();
    return;
  }
  // This split's sums as 16-byte quads of the tile-contiguous partials
  // (16-byte aligned whatever N is), then the tile's ticket.
  constexpr int kZ = 8;  // splits per batch of loads
  const int tile_id = blockIdx.z * gridDim.x + blockIdx.x;
  const int stride = nrows * NT / 4;  // quads per (tile, split)
  const int Q = live / 4;
  float4* base = reinterpret_cast<float4*>(a.part) + (int64_t)tile_id * splits * stride;
  float4* mine = base + (int64_t)blockIdx.y * stride;
  for (int q = threadIdx.x; q < Q; q += kThreads) mine[q] = reinterpret_cast<const float4*>(tile)[q];
  if (!zg2::last_to_arrive(a.tickets + tile_id, splits)) return;
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < splits; z0 += kZ) {
      float4 v[kZ];
#pragma unroll
      for (int z = 0; z < kZ; ++z)
        v[z] = z0 + z < splits ? __ldcg(base + (int64_t)(z0 + z) * stride + q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int z = 0; z < kZ; ++z) {
        if (z0 + z >= splits) break;
        s.x += v[z].x;
        s.y += v[z].y;
        s.z += v[z].z;
        s.w += v[z].w;
      }
    }
    const int r = 4 * q / NT, c = 4 * q % NT;
    const float s4[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = c0 + c + e;
      if (n < a.N) a.out[(int64_t)(r0 + r) * a.N + n] = s4[e];
    }
  }
}

// Weight row k's E = 16 / sizeof(TW) columns from col, as raw bytes: one
// 16-byte load when the row's piece starts on 16 bytes and holds E columns,
// else one element at a time, zeros past N (the narrower path is picked by
// the address). Nothing is read when !ok.
template <typename TW>
__device__ __forceinline__ uint4 load_row(const TW* w, int k, int col, int ncols, int N,
                                          bool ok) {
  using U = typename std::conditional<sizeof(TW) == 4, uint32_t, uint16_t>::type;
  constexpr int E = 16 / sizeof(TW);
  uint4 v = make_uint4(0, 0, 0, 0);
  if (!ok || ncols <= 0) return v;
  const TW* p = w + (int64_t)k * N + col;
  if (ncols == E && ((uintptr_t)p & 15) == 0) return __ldg(reinterpret_cast<const uint4*>(p));
  U e[E];
#pragma unroll
  for (int i = 0; i < E; ++i) e[i] = i < ncols ? reinterpret_cast<const U*>(p)[i] : U(0);
  memcpy(&v, e, 16);
  return v;
}

// CUDA-core body: one row (RT = 1), or f32 x in row tiles of RT = 4.
// Thread t owns the E columns of group t % kGroups and the rows of slice
// t / kGroups (k = k_begin + slice + j kSlices); it reads them with 16-byte
// loads straight into registers, kBatch rows in flight, the first batch
// before x is staged.
template <typename TX, typename TW, int RT, int NT>
__global__ void __launch_bounds__(kThreads, 2) wmm_simt_kernel(const WArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = 16 / sizeof(TW);
  constexpr int kGroups = NT / E;
  constexpr int kSlices = kThreads / kGroups;
  constexpr int kBatch = 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = threadIdx.x % kGroups, slice = threadIdx.x / kGroups;
  const int r0 = blockIdx.x * RT, c0 = blockIdx.z * NT;
  const int k_begin = blockIdx.y * a.split_rows;
  const int k_end = min(a.K, k_begin + a.split_rows);
  const int col = c0 + grp * E;
  const int ncols = min(E, a.N - col);
  const TW* w = static_cast<const TW*>(a.w);
  uint4 v[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = k_begin + slice + j * kSlices;
    v[j] = load_row(w, k, col, ncols, a.N, k < k_end);
  }
  const int ld = a.split_rows;
  float* xs = (float*)smem;
  stage_x<TX>(a, xs, ld, r0, RT, k_begin, k_end);
  __syncthreads();

  float acc[RT][E];
#pragma unroll
  for (int rr = 0; rr < RT; ++rr)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[rr][e] = 0.f;
  for (int k0 = k_begin + slice;; k0 += kBatch * kSlices) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = k0 + j * kSlices;
      if (k >= k_end) break;
      float wv[E];
      unpack<TX, TW>(v[j], wv);
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const float xv = xs[rr * ld + k - k_begin];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[rr][e] = fmaf(xv, wv[e], acc[rr][e]);
      }
    }
    const int next = k0 + kBatch * kSlices;
    if (next >= k_end) break;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = next + j * kSlices;
      v[j] = load_row(w, k, col, ncols, a.N, k < k_end);
    }
  }

#pragma unroll
  for (int rr = 0; rr < RT; ++rr)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = kGroups; o < 32; o <<= 1)
        acc[rr][e] += __shfl_xor_sync(0xffffffffu, acc[rr][e], o);
  float* red = (float*)(smem + RT * a.split_rows * 4);  // (warps, RT, NT)
  float* tile = red + (kThreads / 32) * RT * NT;        // (RT, NT)
  if (lane < kGroups) {
#pragma unroll
    for (int rr = 0; rr < RT; ++rr)
#pragma unroll
      for (int e = 0; e < E; ++e) red[(warp * RT + rr) * NT + grp * E + e] = acc[rr][e];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < RT * NT; o += kThreads) {
    const int rr = o / NT, c = o % NT;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) sum += red[(wi * RT + rr) * NT + c];
    tile[o] = sum;
  }
  __syncthreads();
  finish<NT>(a, tile, RT, r0, c0);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Tensor-core body: bf16 x, MT 16-row tiles per block. Warp w owns the
// tile's columns [NF 8 w, NF 8 (w + 1)), NF = NT / 64 fragments of 8.
template <typename TW, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2) wmm_mma_kernel(const WArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = Staged<TW, NT>;
  constexpr int NF = NT / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  const int r0 = blockIdx.x * 16 * MT, c0 = blockIdx.z * NT;
  const Ring<TW, NT> ring(a, smem, c0, blockIdx.y);
#pragma unroll
  for (int t = 0; t < S::kStages - 1; ++t) ring.issue(t);
  // Row stride of x: (ld / 2) % 32 is 4 or 20 words (split_rows is a
  // multiple of 32), so the 8 row groups of a fragment load fall in
  // distinct banks.
  const int ld = a.split_rows + 8;
  bf16* xs = (bf16*)(smem + ring_stages<TW, NT>(a.split_rows) * S::kStageBytes);
  stage_x<bf16>(a, xs, ld, r0, 16 * MT, ring.k_begin, ring.k_end);
  const int m_tiles = min(MT, (a.rows - r0 + 15) / 16);

  float acc[MT][NF][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][f][i] = 0.f;

  for (int t = 0; t < ring.ntiles; ++t) {
    ring.issue(t + S::kStages - 1);
    zg2::cp_async_wait<S::kStages - 1>();
    __syncthreads();
    const int k0 = ring.k_begin + t * kKT;
    const int nr = min(kKT, ring.k_end - k0);
    const unsigned char* st = ring.stage(t);
#pragma unroll
    for (int s = 0; s < kKT / 16; ++s) {
      if (16 * s >= nr) break;
      // Fragment rows of this k step: 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9
      // (rows past the range are zero-filled, as is x there).
      const int r = 16 * s + 2 * tq;
      uint32_t b[NF][2];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int col = (warp * NF + f) * 8 + g;
        b[f][0] = pack_bf16(ring.elem(st, r, k0 + r, col), ring.elem(st, r + 1, k0 + r + 1, col));
        b[f][1] = pack_bf16(ring.elem(st, r + 8, k0 + r + 8, col),
                            ring.elem(st, r + 9, k0 + r + 9, col));
      }
      const int k = k0 - ring.k_begin + r;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= m_tiles) break;
        const bf16* xa = xs + (m * 16 + g) * ld + k;
        const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(xa),
                                *reinterpret_cast<const uint32_t*>(xa + 8 * ld),
                                *reinterpret_cast<const uint32_t*>(xa + 8),
                                *reinterpret_cast<const uint32_t*>(xa + 8 * ld + 8)};
#pragma unroll
        for (int f = 0; f < NF; ++f) mma_bf16(acc[m][f], af, b[f]);
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }
  zg2::cp_async_wait<0>();
  __syncthreads();

  float* tile = (float*)smem;  // (16 MT, NT); the stages and x are free now
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= m_tiles) break;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int row = m * 16 + g, c = (warp * NF + f) * 8 + 2 * tq;
      tile[row * NT + c] = acc[m][f][0];
      tile[row * NT + c + 1] = acc[m][f][1];
      tile[(row + 8) * NT + c] = acc[m][f][2];
      tile[(row + 8) * NT + c + 1] = acc[m][f][3];
    }
  }
  __syncthreads();
  finish<NT>(a, tile, 16 * MT, r0, c0);
}

// Above 48 KB a block's dynamic shared memory needs an attribute, and a
// cluster of more than 8 blocks another: both set once per body.
template <void (*Kernel)(WArgs)>
cudaError_t allow() {
  cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// cluster_y > 1: blocks (x, y, z) with one x and z and all cluster_y values
// of y form a thread-block cluster (gridDim.y == cluster_y).
template <void (*Kernel)(WArgs)>
cudaError_t launch_kernel(dim3 grid, int smem, const WArgs& a, int cluster_y,
                          cudaStream_t stream) {
  static const cudaError_t allowed = allow<Kernel>();
  if (allowed != cudaSuccess) return allowed;
  if (cluster_y == 1) {
    Kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster_y;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Rows per block: CUDA cores for f32 x or one row (1 or 4), tensor cores for
// bf16 x and two or more rows (16, or 64 above 16 rows).
__host__ __forceinline__ int row_tile(bool bf16_x, int rows) {
  if (bf16_x && rows > 1) return rows <= 16 ? 16 : 64;
  return rows == 1 ? 1 : 4;
}

template <typename TX, typename TW>
cudaError_t launch(const WArgs& a, int splits, cudaStream_t stream) {
  constexpr bool kBf16X = std::is_same<TX, bf16>::value;
  const int rt = row_tile(kBf16X, a.rows);
  const bool mma = rt >= 16;
  const int nt = mma ? kMmaCols : kSimtCols;
  const int x_bytes = mma ? rt * (a.split_rows + 8) * 2 : rt * a.split_rows * 4;
  if (x_bytes > (rt == 64 ? kXBytesWide : kXBytes)) return cudaErrorInvalidValue;
  // The tensor cores stage the weight in the ring, then reuse it for the
  // tile's sums; the CUDA cores hold x, then the per-warp sums and the tile.
  int smem = x_bytes + (kThreads / 32 + 1) * rt * nt * 4;
  if (mma) {
    const int staged = ring_stages<TW, kMmaCols>(a.split_rows) *
                           Staged<TW, kMmaCols>::kStageBytes + x_bytes;
    smem = staged > rt * nt * 4 ? staged : rt * nt * 4;
  }
  const dim3 grid((a.rows + rt - 1) / rt, splits, (a.N + nt - 1) / nt);
  const int cluster = a.cluster ? splits : 1;
  if constexpr (kBf16X) {
    if (rt == 16)
      return launch_kernel<wmm_mma_kernel<TW, 1, kMmaCols>>(grid, smem, a, cluster, stream);
    if (rt == 64)
      return launch_kernel<wmm_mma_kernel<TW, 4, kMmaCols>>(grid, smem, a, cluster, stream);
    return launch_kernel<wmm_simt_kernel<TX, TW, 1, kSimtCols>>(grid, smem, a, cluster, stream);
  } else {
    if (rt == 1)
      return launch_kernel<wmm_simt_kernel<TX, TW, 1, kSimtCols>>(grid, smem, a, cluster,
                                                                   stream);
    return launch_kernel<wmm_simt_kernel<TX, TW, 4, kSimtCols>>(grid, smem, a, cluster, stream);
  }
}

template <typename TX>
cudaError_t dispatch(const WArgs& a, int splits, int wdtype, cudaStream_t stream) {
  if (wdtype == 0) return launch<TX, float>(a, splits, stream);
  if (wdtype == 1) return launch<TX, bf16>(a, splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes of x and w: 0 = float32, 1 = bfloat16. splits x split_rows:
// the K split (split_rows a multiple of 32, the splits covering K with none
// empty); rtile: the rows per block, which must be the body's (1 or 4 for
// the CUDA cores, 16 or 64 for the tensor cores), whose column tile is 64
// or 128; cluster: 1 to add the splits (2 to 16) of an output tile in one
// thread-block cluster, 0 for the ticket. part: (output tiles, splits, row
// tile x column tile) f32 scratch and tickets: one int32 at 0 per output
// tile, unused when splits == 1 or with a cluster. Returns a cudaError_t.
extern "C" int zg2_wmm(const void* x, const void* w, void* part, void* tickets, void* out,
                       int rows, int K, int N, int splits, int split_rows, int rtile,
                       int cluster, int xdtype, int wdtype, void* stream) {
  if (rows < 1 || rows > 256 || K < 1 || N < 1 || splits < 1 || split_rows < kKT ||
      split_rows % kKT || (int64_t)splits * split_rows < K ||
      (int64_t)(splits - 1) * split_rows >= K || (xdtype != 0 && xdtype != 1) ||
      rtile != row_tile(xdtype == 1, rows) ||
      (cluster && (splits < 2 || splits > kMaxCluster)) ||
      (splits > 1 && !cluster && (!part || !tickets)))
    return cudaErrorInvalidValue;
  const WArgs a{x, w, (float*)part, (int*)tickets, (float*)out, rows, K, N, split_rows,
                cluster != 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (xdtype == 0) return dispatch<float>(a, splits, wdtype, st);
  return dispatch<bf16>(a, splits, wdtype, st);
}
