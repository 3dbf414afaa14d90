// Fused dequant GEMV for weight-only INT8 / INT4, and its w8a8 (s8 x s8)
// body, on Hopper (sm_90a).
//
// Replaces: zig_gpt2_tpu/quant/kernels.py, qmm (body _qmm_kernel), with its
// w8a8 branch. Same contract: x (rows, K) f32 or bf16, rows <= 256 (64 for
// w8a8); qw (K, N) int8, or (K/2, N) int8 holding the INT4 half-split pack
// (packed row p: original row p in the low nibble, row p + K/2 in the high
// nibble, both sign-extended); scale (K/G, N) f32. Output (rows, N) f32:
//
//   grouped (G < K):  y[r, n] = sum_k x[r, k] * round_x(float(q[k, n]) * scale[k / G, n])
//   per-channel:      y[r, n] = (sum_k x[r, k] * float(q[k, n])) * scale[0, n]
//   w8a8:             y[r, n] = float(sum_k xq[r, k] * q[k, n]) * sx[r] * scale[0, n]
//
// round_x rounds to the activation dtype (nothing for f32, bf16 for bf16),
// as the TPU kernel casts its dequantized tile to x's dtype before its dot.
// A bf16 x times a bf16 or int8 weight is exact in f32, and every sum is
// f32. The w8a8 body (per-channel INT8 weights only) quantizes each row of x
// as the TPU kernel does: sx = max(absmax, 1e-12) / 127 in f32, xq =
// clip(rint(x / sx), -127, 127) (a division, rounded half to even), and
// sums xq * q in int32, which is exact; the f32 tail is taken in the plain
// version's order, so the two agree bit for bit. This file must be built
// without fast math (no -use_fast_math: x / sx is IEEE division).
//
// Bound on the H100: device-memory bytes for a decode call. A call with
// one row reads each weight byte once and does 2 operations per weight,
// about 4 per byte at INT4, below the ~20 flops per byte where the f32 units
// would become the limit. At GPT-2 1.5B: c_fc is a 5.12 MB INT4 tile plus
// 1.28 MB of scales, 1.9 us at 3.35 TB/s; the INT8 lm_head is 80.4 MB,
// 24 us; a w8a8 c_fc is 10.24 MB, 3.1 us, and a w8a8 B=1 step's 289 GEMVs
// about 1.58 GB, 0.47 ms. At 16 rows and more the products come into it:
// one CUDA-core multiply-add per weight and row would be 16 instructions
// per weight for the batcher; the bf16 and s8 tensor cores do them for
// almost nothing (a 16-row w8a8 step's 2 x 16 x 1.58 G int8 operations
// take 0.03 ms at 1979 TOP/s). So the bound stays the weight's bytes.
//
// Design of the weight-only bodies against that bound:
// - One launch per call. The grid is (row tiles, column tiles of 128,
//   K splits); the host picks the split from the shapes alone
//   (quant/kernels.py qmm_geometry) so that the card holds a few blocks per
//   SM. Each block writes its partial sums, takes a ticket from a
//   self-resetting counter per output tile, and the last block to arrive
//   adds the splits in split order and applies the per-channel scale, so
//   the result does not depend on the arrival order. (A cluster reducing
//   through distributed shared memory was the other choice; it caps the
//   splits at 8 or 16 and the 1.5B MLP c_proj takes 17.) The separate
//   reduce launch of PR 2 is gone: 289 launches per 1.5B decode step.
// - Weight tiles of 64 packed rows x 128 columns reach shared memory by
//   16-byte cp.async in a ring of 3 stages (9 KB each, up to 27 KB in
//   flight per block besides the scales), so the card keeps far more bytes
//   in flight than PR 2's one-byte loads. (5 stages were no faster on the
//   H100.) A row whose 128 bytes are not
//   16-byte aligned (any N that is not a multiple of 16: the lm_head's
//   50257, the tests' 150) is copied as the 9 aligned 16-byte pieces that
//   cover it and read at its offset: the narrower path, picked by the
//   address, not by failure. Group scales (G >= 8) are staged beside each
//   tile with 4-byte copies, with a per-row index into them; a smaller G
//   reads its scales from L2.
// - x of the block's rows over its K range is read once into shared
//   memory before the loop (while the first tiles are in flight).
// - One row, or f32 x at any rows: CUDA cores. Each lane owns 4
//   neighbouring columns (one 32-bit shared load of 4 weights), each of
//   the 8 warps 8 of the tile's 64 rows, and the warps' sums are added in
//   warp order at the end. f32 x stays on f32 FMAs (TF32 would break the
//   2e-5 tolerance). Rows tile by 4.
// - Two or more rows with bf16 x: tensor cores, mma.sync.m16n8k16 (bf16 in,
//   f32 sums). Each warp dequantizes its 16 columns of the tile straight
//   into B fragments (nibble or int8, times the group scale, rounded to
//   bf16 as round_x does; per-channel weights are exact in bf16 and the
//   scale comes at the end), and reuses them for every 16-row A tile of x
//   in the block: 16 rows (the batcher's B=16 in one pass over the weight)
//   or 64. Above 64 rows, the row blocks of one weight tile sit next to
//   each other in launch order, so the weight is read from device memory
//   about once and from L2 after that. bf16 products are exact in f32: only
//   the order of the f32 sums differs from the plain version.
//
// Design of the w8a8 body (per-channel INT8 weight, x quantized per row):
// - One launch per call. The grid is (column tiles of 128, K splits); the
//   host picks the split from the shapes alone (quant/kernels.py
//   w8a8_geometry). Two combines, both exact in any order (integer sums),
//   so the result cannot depend on the arrival order:
//   - a narrow weight with a short K (GPT-2 1.5B's attention linears: 13
//     column tiles, K 1600 or 1664) splits into at most 8 ranges, and the
//     splits of a column tile form one thread-block cluster: after a
//     cluster barrier each block adds a share of the tile's outputs from
//     every block's shared memory, in split order. No partial sums reach
//     device memory and no block waits on a ticket (1 us less per call
//     than the ticket at these shapes on the H100);
//   - otherwise (the MLP's c_fc with 50 column tiles, where the cluster was
//     2 us slower, and c_proj, whose 6400 rows want 20 splits) each block
//     writes its int32 sums as a contiguous tile (16-byte stores at any N),
//     takes a ticket from the column tile's self-resetting counter
//     (zg2::last_to_arrive), and the last block to arrive adds the splits'
//     tiles in split order (16 16-byte loads in flight per thread).
//   Either applies float(acc) * sx[r] * scale[n]. The separate int32 reduce
//   launch of the first w8a8 body is gone.
// - Weight tiles reach shared memory through the weight-only body's ring
//   (Tiles: 64 rows x 128 columns, 16-byte cp.async, 3 stages, any row
//   alignment). Rows that start off 16 bytes (N % 16 != 0: the lm_head's
//   50257, the tests' 150) read each 4-byte word as a funnel shift of two
//   aligned ones; a 16-byte-aligned N takes one load per word.
// - Products on the tensor cores at every row count:
//   mma.sync.m16n8k32.s32.s8.s8.s32, exact. All of the call's rows (16-row
//   tiles, 1 to 4 per block) go against one pass over each weight tile;
//   the padding rows of the last tile hold whatever shared memory held,
//   since the mma keeps rows apart and their sums are never read. Warp w owns the tile's columns [32 (w % 4), +32) and the tile's
//   32-row k step w / 4; the two steps' sums are added in shared memory at
//   the end. A B fragment register (4 k of one column) comes from four
//   32-bit words of four weight rows by a 4 x 4 byte transpose
//   (__byte_perm): a lane reads columns 4 g .. 4 g + 3, so n-tile c of the
//   warp holds its columns 4 g + c. The k order within a step is permuted
//   (frag_pos) so that those reads are free of bank conflicts, and xq is
//   stored in that order, so an A fragment register is one 32-bit load. One
//   row runs the same mma with 15 padding rows: it is bound by the weight's
//   bytes either way, and one body is simpler than a __dp4a twin.
// - x is quantized once per block (stage_xq): every block reduces its
//   rows' absmax over the whole of K with 16-byte loads (x is at most 64 x
//   6400 x 2 bytes and sits in L2), sx = max(absmax, 1e-12) / 127 by IEEE
//   division, then writes xq of its own K range only into shared memory as
//   int8, xq = clip(rint(x / sx), -127, 127) (__fdiv_rn, rintf: half to
//   even). A block's first x loads go out before its first weight tiles'
//   copies. (Tried and slower on the H100: thread-block clusters of 8
//   column tiles sharing these reads through distributed shared memory, 13
//   tiles padded to 16 putting a 16-row c_proj call in two waves; and a
//   programmatic dependent launch: 2.76 ms per B=1 step, 2.68 without, in
//   two runs.)

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

// The weight-only bodies.
constexpr int kThreads = 256;         // 8 warps
constexpr int kNT = 128;              // output columns per block
constexpr int kKT = 64;               // packed weight rows per tile
constexpr int kStages = 3;            // tiles in flight per block
constexpr int kWS = kNT + 16;         // bytes per staged weight row (misaligned pieces)
constexpr int kPieces = kWS / 16;     // 16-byte copies per staged row
constexpr int kMaxGroupRows = 9;      // scale rows a tile touches: (kKT - 1) / G + 2, G >= 8
constexpr int kXBytes = 32768;        // x in shared memory: CUDA cores, 16-row mma
constexpr int kXBytesWide = 65536;    // 64-row mma
constexpr int kW8XBytes = 32768;      // xq in shared memory: the w8a8 body's 16-row tile
constexpr int kW8XBytesWide = 65536;  // ... its 32- and 64-row tiles
constexpr int kMaxSmem = kStages * (kKT * kWS + 2 * kKT + 2 * kMaxGroupRows * kNT * 4) +
                         kXBytesWide;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Two dequantized weights rounded to the activation dtype (one packed
// conversion for bf16; nothing for f32).
__device__ __forceinline__ void round_pair(float&, float&, const float*) {}
__device__ __forceinline__ void round_pair(float& a, float& b, const __nv_bfloat16*) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  a = __low2float(r);
  b = __high2float(r);
}

// Weights as floats without a conversion instruction: a byte k in [0, 255]
// placed under the exponent of 2^23 is the float 2^23 + k, exactly. So the
// signed nibble n is (2^23 + (n ^ 8)) - (2^23 + 8), and the signed byte b
// is (2^23 + (b ^ 0x80)) - (2^23 + 128). ``lanes`` holds four such k, one
// per byte; byte_float picks byte i.
__device__ __forceinline__ float byte_float(uint32_t lanes, int i, float bias) {
  return __uint_as_float(__byte_perm(lanes, 0x4B000000u, 0x7540 + i)) - bias;
}
constexpr float kNibbleBias = 8388616.0f;  // 2^23 + 8
constexpr float kByteBias = 8388736.0f;    // 2^23 + 128
// The four low (high) nibbles of v, each xor 8, one per byte.
__device__ __forceinline__ uint32_t low_nibbles(uint32_t v) {
  return (v & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t high_nibbles(uint32_t v) {
  return ((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// Every pointer and size of one weight-only call. split_rows: packed rows
// per K split, a multiple of kKT; splits is gridDim.z. part: (splits, rows,
// N) f32 and tickets: one int32 at 0 per (row tile, column tile), unused
// when splits == 1.
struct QArgs {
  const void* x;
  const int8_t* qw;
  const float* scale;
  float* part;
  int* tickets;
  float* out;
  int rows, K, N, G, split_rows;
  int cluster;  // w8a8 body: the splits of a column tile form one cluster
};

// Scale rows per set staged with a tile (0: the scales are read from L2).
__host__ __device__ __forceinline__ int group_rows(int K, int G) {
  if (G == K || G < 8) return 0;
  const int n = (kKT - 1) / G + 2;
  return n < kMaxGroupRows ? n : kMaxGroupRows;
}

__host__ __device__ __forceinline__ int stage_bytes(bool int4, int K, int G) {
  const int gr = group_rows(K, G);
  return kKT * kWS + (gr ? 2 * kKT + (int4 ? 2 : 1) * gr * kNT * 4 : 0);
}

// The ring of weight tiles of one block: columns [c0, c0 + kNT), packed
// rows [p_begin, p_end) in tiles of kKT. A stage holds the tile's rows
// (kWS bytes each, a row's first column at its 16-byte offset), then, for
// staged group scales, each row's index into the stage's scale rows (low,
// high) and the scale rows (low; high for INT4). Holds the sizes it needs
// by value (a reference to the kernel's parameter would put it in local
// memory).
template <bool INT4>
struct Tiles {
  const int8_t* qw;
  const float* scale;
  unsigned char* smem;
  int K, N, G, bytes, c0, ncols, p_begin, p_end, ntiles, half, gr;

  __device__ __forceinline__ Tiles(const QArgs& a, unsigned char* s, int col0, int split)
      : qw(a.qw), scale(a.scale), smem(s), K(a.K), N(a.N), G(a.G), c0(col0) {
    half = K / 2;
    const int P = INT4 ? half : K;
    gr = group_rows(K, G);
    bytes = stage_bytes(INT4, K, G);
    ncols = min(kNT, N - c0);
    p_begin = split * a.split_rows;
    p_end = min(P, p_begin + a.split_rows);
    ntiles = p_end > p_begin ? (p_end - p_begin + kKT - 1) / kKT : 0;
  }
  __device__ __forceinline__ unsigned char* stage(int t) const {
    return smem + (t % kStages) * bytes;
  }
  __device__ __forceinline__ const int8_t* w(int t) const { return (const int8_t*)stage(t); }
  __device__ __forceinline__ unsigned char* index(int t, int set) const {
    return stage(t) + kKT * kWS + set * kKT;
  }
  __device__ __forceinline__ float* scales(int t, int set) const {
    return (float*)(stage(t) + kKT * kWS + 2 * kKT) + set * gr * kNT;
  }
  // Byte offset of packed row p's first column in its staged row.
  __device__ __forceinline__ int shift(int p) const {
    return (int)((uintptr_t)(qw + (int64_t)p * N + c0) & 15);
  }

  // Copy tile t into its stage; an empty group past the last tile keeps
  // the wait counts uniform.
  __device__ __forceinline__ void issue(int t) const {
    if (t < ntiles) {
      const int p0 = p_begin + t * kKT;
      const int nr = min(kKT, p_end - p0);
      unsigned char* st = stage(t);
      const char* safe = (const char*)((uintptr_t)qw & ~(uintptr_t)15);
      for (int c = threadIdx.x; c < kKT * kPieces; c += kThreads) {
        const int r = c / kPieces, j = c - r * kPieces;
        const char* row = (const char*)(qw + (int64_t)(p0 + r) * N + c0);
        const int sh = (int)((uintptr_t)row & 15);
        // Each piece holds a byte of the row, so it lies on a mapped page.
        const bool ok = r < nr && 16 * j < sh + ncols;
        zg2::cp_async16(st + r * kWS + 16 * j, ok ? row - sh + 16 * j : safe, ok);
      }
      if (gr) {
        const int ngroups = K / G;
        for (int set = 0; set < (INT4 ? 2 : 1); ++set) {
          const int first = p0 + set * half;  // original row of the tile's first row
          const int g0 = first / G;
          const int g1 = (first + nr - 1) / G;
          unsigned char* idx = index(t, set);
          for (int r = threadIdx.x; r < kKT; r += kThreads)
            idx[r] = r < nr ? (first + r) / G - g0 : 0;
          float* sc = scales(t, set);
          for (int c = threadIdx.x; c < gr * kNT; c += kThreads) {
            const int g = g0 + c / kNT, col = c % kNT;
            const bool ok = g <= g1 && g < ngroups && col < ncols;
            zg2::cp_async4(sc + c, ok ? scale + (int64_t)g * N + c0 + col : scale, ok);
          }
        }
      }
    }
    zg2::cp_async_commit();
  }

  // The group scales of tile row r (original row p: low rows set 0, the
  // high rows of an INT4 pack set 1) for the block's columns col .. col +
  // NC - 1 (NC = 4: 16-byte aligned col), from the stage, or with small
  // groups (not staged) from L2.
  template <int NC>
  __device__ __forceinline__ void group_scales(int t, int set, int r, int p, int col,
                                               float* out) const {
    if (gr) {
      const float* sc = scales(t, set) + index(t, set)[r] * kNT + col;
      if constexpr (NC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(sc);
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < NC; ++i) out[i] = sc[i];
      }
      return;
    }
    const int g = p / G;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      out[i] = c0 + col + i < N && g < K / G ? __ldg(scale + (int64_t)g * N + c0 + col + i)
                                            : 0.f;
  }
  // Whether aligned runs of n tile rows share their group in both sets (n
  // divides G and K / 2; tiles start at multiples of 64): the tensor-core
  // body then looks a run's scale up once.
  __device__ __forceinline__ bool shares(int n) const { return G % n == 0 && half % n == 0; }
};

// One output of this block's K range: the result of a one-split launch
// (times the per-channel scale), else this split's partial sum.
__device__ __forceinline__ void put(const QArgs& a, bool per_channel, int row, int col,
                                    float v) {
  if (row >= a.rows || col >= a.N) return;
  if (gridDim.z == 1)
    a.out[(int64_t)row * a.N + col] = per_channel ? v * a.scale[col] : v;
  else
    a.part[((int64_t)blockIdx.z * a.rows + row) * a.N + col] = v;
}

// After every put of the block: the last block of the output tile to
// arrive adds the splits in split order and applies the per-channel scale.
// Each thread owns U = NROWS * kNT / kThreads outputs and reads their
// partials kZ splits at a time, so that U * kZ loads are in flight at once.
template <int NROWS>
__device__ __forceinline__ void finish(const QArgs& a, bool per_channel, int r0, int c0) {
  constexpr int U = (NROWS * kNT + kThreads - 1) / kThreads;
  constexpr int kZ = U >= 16 ? 2 : 8;
  if (gridDim.z == 1) return;
  if (!zg2::last_to_arrive(a.tickets + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z))
    return;
  const int64_t total = (int64_t)a.rows * a.N;
  const int splits = gridDim.z;
  int64_t at[U];
  bool ok[U];
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int o = threadIdx.x + u * kThreads;
    const int row = r0 + o / kNT, col = c0 + o % kNT;
    ok[u] = o < NROWS * kNT && row < a.rows && col < a.N;
    at[u] = ok[u] ? (int64_t)row * a.N + col : 0;
    s[u] = 0.f;
  }
  for (int z0 = 0; z0 < splits; z0 += kZ) {
    float v[kZ][U];
#pragma unroll
    for (int z = 0; z < kZ; ++z)
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[z][u] = ok[u] && z0 + z < splits ? __ldcg(a.part + (z0 + z) * total + at[u]) : 0.f;
#pragma unroll
    for (int z = 0; z < kZ; ++z)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (z0 + z < splits) s[u] += v[z][u];
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u]) a.out[at[u]] = per_channel ? s[u] * a.scale[at[u] % a.N] : s[u];
}

// x rows [r0, r0 + nrows) over the packed rows [p_begin, p_end) into
// shared memory as U (f32 or bf16), row stride ld: low rows at [0, sr),
// for INT4 the high rows (p + K/2) at [sr, 2 sr); zeros past the rows and
// the range. Loads go out kBatch at a time per thread, so that their
// latencies overlap.
template <bool INT4, typename T, typename U>
__device__ __forceinline__ void stage_x(const QArgs& a, U* xs, int ld, int r0, int nrows,
                                        int p_begin, int p_end) {
  constexpr int kBatch = 8;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  const T* x = static_cast<const T*>(a.x);
  const int sr = a.split_rows;
  const int width = INT4 ? 2 * sr : sr;
  // 16 bytes at a time when every row and range starts on 16 bytes (K and
  // K / 2 multiples of E; split_rows is a multiple of 64), else one element.
  const bool vec = ((uintptr_t)x & 15) == 0 && a.K % E == 0 && (!INT4 || (a.K / 2) % E == 0);
  const int step = vec ? E : 1;
  const int total = nrows * width / step;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    uint4 w[kBatch];  // 16 raw bytes, or one f32 in .x
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i * step / width, j = i * step - r * width;
      const bool high = INT4 && j >= sr;
      const int p = p_begin + (high ? j - sr : j);
      const int64_t at = (int64_t)(r0 + r) * a.K + p + (high ? a.K / 2 : 0);
      // A 16-byte piece is wholly inside or wholly past the range: p_end is
      // P or a multiple of 64, and P is a multiple of E.
      const bool ok = i < total && r0 + r < a.rows && p < p_end;
      w[u] = make_uint4(0, 0, 0, 0);
      if (vec && ok)
        w[u] = __ldg(reinterpret_cast<const uint4*>(x + at));
      else if (ok)
        w[u].x = __float_as_uint(to_f32(x[at]));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= total) break;
      const int r = i * step / width, j = i * step - r * width;
      const T* e = reinterpret_cast<const T*>(&w[u]);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        if (k >= step) break;
        const float v = vec ? to_f32(e[k]) : __uint_as_float(w[u].x);
        if constexpr (std::is_same<U, float>::value)
          xs[r * ld + j + k] = v;
        else
          xs[r * ld + j + k] = __float2bfloat16(v);  // exact: x is bf16
      }
    }
  }
}

// CUDA-core body: one row (RT = 1), or f32 x in row tiles of RT = 4.
template <typename T, bool INT4, bool PER_CHANNEL, int RT>
__global__ void __launch_bounds__(kThreads, 2) qmm_simt_kernel(const QArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * RT, c0 = blockIdx.y * kNT;
  const Tiles<INT4> tiles(a, smem, c0, blockIdx.z);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) tiles.issue(t);
  const int ld = INT4 ? 2 * a.split_rows : a.split_rows;
  float* xs = (float*)(smem + kStages * tiles.bytes);
  stage_x<INT4, T>(a, xs, ld, r0, RT, tiles.p_begin, tiles.p_end);

  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;

  for (int t = 0; t < tiles.ntiles; ++t) {
    tiles.issue(t + kStages - 1);
    zg2::cp_async_wait<kStages - 1>();
    __syncthreads();
    const int p0 = tiles.p_begin + t * kKT;
    const int nr = min(kKT, tiles.p_end - p0);
    const int8_t* w = tiles.w(t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = warp * 8 + j;  // the warp's rows of the tile
      if (r >= nr) break;
      const int p = p0 + r;
      const int sh = tiles.shift(p);
      const int8_t* wr = w + r * kWS + sh + 4 * lane;
      uint32_t v;  // the 4 weight bytes of columns 4 lane .. 4 lane + 3
      if ((sh & 3) == 0)
        v = *reinterpret_cast<const uint32_t*>(wr);
      else
        v = (uint32_t)(uint8_t)wr[0] | (uint32_t)(uint8_t)wr[1] << 8 |
            (uint32_t)(uint8_t)wr[2] << 16 | (uint32_t)(uint8_t)wr[3] << 24;
      const int xo = p - tiles.p_begin;
      float xl[RT], xh[RT];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        xl[rr] = xs[rr * ld + xo];
        xh[rr] = INT4 ? xs[rr * ld + a.split_rows + xo] : 0.f;
      }
      float sl[4], sh4[4];
      if (!PER_CHANNEL) {
        tiles.template group_scales<4>(t, 0, r, p, 4 * lane, sl);
        if (INT4) tiles.template group_scales<4>(t, 1, r, p + tiles.half, 4 * lane, sh4);
      }
      // Columns 4 lane + i: the low rows' weights, and the high rows' of an
      // INT4 pack.
      float wl[4], wh[4];
      const uint32_t lo = INT4 ? low_nibbles(v) : v ^ 0x80808080u;
      const uint32_t hi = INT4 ? high_nibbles(v) : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wl[i] = byte_float(lo, i, INT4 ? kNibbleBias : kByteBias);
        wh[i] = INT4 ? byte_float(hi, i, kNibbleBias) : 0.f;
        if (!PER_CHANNEL) {
          wl[i] *= sl[i];
          if (INT4) wh[i] *= sh4[i];
        }
      }
      if (!PER_CHANNEL) {
        round_pair(wl[0], wl[1], (const T*)nullptr);
        round_pair(wl[2], wl[3], (const T*)nullptr);
        if (INT4) {
          round_pair(wh[0], wh[1], (const T*)nullptr);
          round_pair(wh[2], wh[3], (const T*)nullptr);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          acc[rr][i] += xl[rr] * wl[i];
          if (INT4) acc[rr][i] += xh[rr] * wh[i];
        }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }
  zg2::cp_async_wait<0>();
  __syncthreads();

  // The warps' sums, added in warp order (the stages are free now).
  float* red = (float*)smem;
#pragma unroll
  for (int rr = 0; rr < RT; ++rr)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(warp * RT + rr) * kNT + 4 * lane + i] = acc[rr][i];
  __syncthreads();
  for (int o = threadIdx.x; o < RT * kNT; o += kThreads) {
    const int rr = o / kNT, col = o % kNT;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) v += red[(wi * RT + rr) * kNT + col];
    put(a, PER_CHANNEL, r0 + rr, c0 + col, v);
  }
  finish<RT>(a, PER_CHANNEL, r0, c0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
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
// tile's columns [16 w, 16 w + 16) as two 8-column fragments.
template <bool INT4, bool PER_CHANNEL, int MT>
__global__ void __launch_bounds__(kThreads, 2) qmm_mma_kernel(const QArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  const int r0 = blockIdx.x * 16 * MT, c0 = blockIdx.y * kNT;
  const Tiles<INT4> tiles(a, smem, c0, blockIdx.z);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) tiles.issue(t);
  // Row stride of x: (ld / 2) % 32 == 4 words, so the 8 row groups of a
  // fragment load fall in distinct banks.
  const int ld = (INT4 ? 2 * a.split_rows : a.split_rows) + 8;
  __nv_bfloat16* xs = (__nv_bfloat16*)(smem + kStages * tiles.bytes);
  stage_x<INT4, __nv_bfloat16>(a, xs, ld, r0, 16 * MT, tiles.p_begin, tiles.p_end);
  const int m_tiles = min(MT, (a.rows - r0 + 15) / 16);

  float acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][f][i] = 0.f;

  for (int t = 0; t < tiles.ntiles; ++t) {
    tiles.issue(t + kStages - 1);
    zg2::cp_async_wait<kStages - 1>();
    __syncthreads();
    const int p0 = tiles.p_begin + t * kKT;
    const int nr = min(kKT, tiles.p_end - p0);
    const int8_t* w = tiles.w(t);
#pragma unroll
    for (int s = 0; s < kKT / 16; ++s) {
      if (16 * s >= nr) break;
      // Fragment rows of this k step: 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9.
      int rows4[4] = {16 * s + 2 * tq, 16 * s + 2 * tq + 1, 16 * s + 2 * tq + 8,
                      16 * s + 2 * tq + 9};
      int sh[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[e] = tiles.shift(p0 + rows4[e]);
      const bool share = tiles.shares(2), quad = tiles.shares(16);
      uint32_t blo[2][2], bhi[2][2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int col = warp * 16 + f * 8 + g;
        float lo[4], hi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t b = (uint8_t)w[rows4[e] * kWS + sh[e] + col];
          lo[e] = byte_float(INT4 ? low_nibbles(b) : b ^ 0x80u, 0,
                             INT4 ? kNibbleBias : kByteBias);
          hi[e] = INT4 ? byte_float(high_nibbles(b), 0, kNibbleBias) : 0.f;
        }
        if (!PER_CHANNEL) {
          // The fragment's rows 2 tq, 2 tq + 1, 2 tq + 8 and 2 tq + 9 share a
          // group when 16 divides G (and K / 2 for INT4), a pair when 2 does;
          // otherwise each row looks its own up.
          float sc[2][4];
#pragma unroll
          for (int set = 0; set < (INT4 ? 2 : 1); ++set) {
            const int off = set * tiles.half;
            tiles.template group_scales<1>(t, set, rows4[0], p0 + rows4[0] + off, col,
                                           &sc[set][0]);
            if (quad) {
              sc[set][1] = sc[set][2] = sc[set][3] = sc[set][0];
            } else {
              tiles.template group_scales<1>(t, set, rows4[2], p0 + rows4[2] + off, col,
                                             &sc[set][2]);
#pragma unroll
              for (int e = 0; e < 4; e += 2) {
                if (share)
                  sc[set][e + 1] = sc[set][e];
                else
                  tiles.template group_scales<1>(t, set, rows4[e + 1],
                                                 p0 + rows4[e + 1] + off, col, &sc[set][e + 1]);
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lo[e] *= sc[0][e];
            if (INT4) hi[e] *= sc[1][e];
          }
        }
        blo[f][0] = pack_bf16(lo[0], lo[1]);
        blo[f][1] = pack_bf16(lo[2], lo[3]);
        if (INT4) {
          bhi[f][0] = pack_bf16(hi[0], hi[1]);
          bhi[f][1] = pack_bf16(hi[2], hi[3]);
        }
      }
      const int k = p0 - tiles.p_begin + 16 * s + 2 * tq;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= m_tiles) break;
        const __nv_bfloat16* xa = xs + (m * 16 + g) * ld + k;
        uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(xa),
                          *reinterpret_cast<const uint32_t*>(xa + 8 * ld),
                          *reinterpret_cast<const uint32_t*>(xa + 8),
                          *reinterpret_cast<const uint32_t*>(xa + 8 * ld + 8)};
        mma_bf16(acc[m][0], af, blo[0]);
        mma_bf16(acc[m][1], af, blo[1]);
        if (INT4) {
          const __nv_bfloat16* xh = xa + a.split_rows;
          uint32_t ah[4] = {*reinterpret_cast<const uint32_t*>(xh),
                            *reinterpret_cast<const uint32_t*>(xh + 8 * ld),
                            *reinterpret_cast<const uint32_t*>(xh + 8),
                            *reinterpret_cast<const uint32_t*>(xh + 8 * ld + 8)};
          mma_bf16(acc[m][0], ah, bhi[0]);
          mma_bf16(acc[m][1], ah, bhi[1]);
        }
      }
    }
    __syncthreads();
  }
  zg2::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= m_tiles) break;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int row = r0 + m * 16 + g;
      const int col = c0 + warp * 16 + f * 8 + 2 * tq;
      put(a, PER_CHANNEL, row, col, acc[m][f][0]);
      put(a, PER_CHANNEL, row, col + 1, acc[m][f][1]);
      put(a, PER_CHANNEL, row + 8, col, acc[m][f][2]);
      put(a, PER_CHANNEL, row + 8, col + 1, acc[m][f][3]);
    }
  }
  finish<16 * MT>(a, PER_CHANNEL, r0, c0);
}

// cluster_y > 1: blocks (x, y) with one x and cluster_y consecutive y form a
// thread-block cluster (grid.y a multiple of it).
template <void (*Kernel)(QArgs)>
cudaError_t launch_kernel(dim3 grid, int smem, const QArgs& a, cudaStream_t stream,
                          int cluster_y = 1) {
  // Above 48 KB a block's dynamic shared memory needs the attribute: set
  // once per body, to the most any call asks for.
  static const cudaError_t allowed =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
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

// The body for (T, rows): CUDA cores for f32 x or one row (row tile 1 or
// 4), tensor cores for bf16 x and two or more rows (row tile 16 or 64).
template <typename T>
int row_tile(int rows) {
  if (std::is_same<T, __nv_bfloat16>::value && rows > 1) return rows <= 16 ? 16 : 64;
  return rows == 1 ? 1 : 4;
}

template <typename T, bool INT4, bool PER_CHANNEL>
cudaError_t launch(const QArgs& a, int splits, cudaStream_t stream) {
  const int rt = row_tile<T>(a.rows);
  const bool mma = rt >= 16;
  const int width = INT4 ? 2 * a.split_rows : a.split_rows;
  const int x_bytes = mma ? rt * (width + 8) * 2 : rt * width * 4;
  if (x_bytes > (rt == 64 ? kXBytesWide : kXBytes)) return cudaErrorInvalidValue;
  const int smem = kStages * stage_bytes(INT4, a.K, a.G) + x_bytes;
  const dim3 grid((a.rows + rt - 1) / rt, (a.N + kNT - 1) / kNT, splits);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (rt == 16)
      return launch_kernel<qmm_mma_kernel<INT4, PER_CHANNEL, 1>>(grid, smem, a, stream);
    if (rt == 64)
      return launch_kernel<qmm_mma_kernel<INT4, PER_CHANNEL, 4>>(grid, smem, a, stream);
  }
  if (rt == 1)
    return launch_kernel<qmm_simt_kernel<T, INT4, PER_CHANNEL, 1>>(grid, smem, a, stream);
  return launch_kernel<qmm_simt_kernel<T, INT4, PER_CHANNEL, 4>>(grid, smem, a, stream);
}

template <typename T>
cudaError_t dispatch(const QArgs& a, int splits, int int4, cudaStream_t stream) {
  const bool per_channel = a.G == a.K;
  if (int4)
    return per_channel ? launch<T, true, true>(a, splits, stream)
                       : launch<T, true, false>(a, splits, stream);
  return per_channel ? launch<T, false, true>(a, splits, stream)
                     : launch<T, false, false>(a, splits, stream);
}

// ---- The w8a8 body ----

// d += a (16x32, row) * b (32x8, col), s8 in, s32 sums (exact).
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The k order of a 32-row k step. Fragment k f = 4 tq + i (f < 16) of the
// B fragment's first register is weight row 2 tq + 8 i of the step, f = 16
// + 4 tq + i its row 2 tq + 8 i + 1: the four rows that the four tq of a
// warp read at once lie 2 rows apart, which with kWS = 144-byte rows puts
// them in four distinct 8-bank groups. xq is stored in fragment order, so
// an A fragment register is one 32-bit load. frag_pos maps a row r of the
// step to its fragment k.
__device__ __forceinline__ int frag_pos(int r) {
  const int h = r & 1, e = r - h;
  return 16 * h + 4 * ((e & 7) >> 1) + (e >> 3);
}

// The 4 x 4 byte transpose: w[i] holds row i's bytes for 4 columns; col[c]
// gets column c's bytes of rows 0..3, row 0 in the low byte.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* col) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// Four consecutive x elements of one row (16 bytes of f32, 8 of bf16) and
// their conversion.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using V = uint4;
  __device__ __forceinline__ static void unpack(const V& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using V = uint2;
  __device__ __forceinline__ static void unpack(const V& v, float* f) {
    f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xFFFF0000u);
    f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xFFFF0000u);
  }
};

// The prologue of the w8a8 body: each row's scale over the whole of K,
// sx[r] = max(absmax, 1e-12) / 127 (IEEE division, as the plain version's),
// then xq of the block's K range in shared memory, in fragment order per
// 32-row step, zeros past the range: xq = clip(rint(x / sx), -127, 127).
// For the absmax, tpr threads share a row (16 bytes per load); their maxima
// meet by warp shuffle and in shared memory (non-negative floats order as
// their bits). issue() starts the weight tiles' copies: it runs after the
// block's first x loads are in flight, so that they are not queued behind
// the weight's.
template <typename T, typename Issue>
__device__ __forceinline__ void stage_xq(const QArgs& a, int p_begin, int p_end, int8_t* xq,
                                         int ld, float* sx, Issue issue) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPre = 4;            // loads per thread in flight before issue()
  __shared__ int smax[64];
  const T* x = static_cast<const T*>(a.x);

  if (threadIdx.x < a.rows) smax[threadIdx.x] = 0;
  __syncthreads();
  {
    int tpr = kThreads;
    while (tpr * a.rows > kThreads) tpr >>= 1;
    const int r = threadIdx.x / tpr, s = threadIdx.x % tpr;
    const bool vec = ((uintptr_t)x & 15) == 0 && a.K % E == 0;
    const int u1 = vec ? a.K / E : a.K;  // loads per row
    const T* xr = x + (int64_t)min(r, a.rows - 1) * a.K;
    float m = 0.f;
    if (vec) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      uint4 w[kPre];
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int j = s + u * tpr;
        w[u] = r < a.rows && j < u1 ? __ldg(xv + j) : make_uint4(0, 0, 0, 0);
      }
      issue();
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const T* e = reinterpret_cast<const T*>(&w[u]);
#pragma unroll
        for (int k = 0; k < E; ++k) m = fmaxf(m, fabsf(to_f32(e[k])));
      }
      if (r < a.rows) {
#pragma unroll 8
        for (int j = s + kPre * tpr; j < u1; j += tpr) {
          const uint4 v = __ldg(xv + j);
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int k = 0; k < E; ++k) m = fmaxf(m, fabsf(to_f32(e[k])));
        }
      }
    } else {
      issue();
      if (r < a.rows) {
#pragma unroll 4
        for (int k = s; k < u1; k += tpr) m = fmaxf(m, fabsf(to_f32(xr[k])));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)  // lanes of one row only: tpr is a power of two
      if (o < tpr) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (r < a.rows && (s & 31) == 0) atomicMax(smax + r, __float_as_int(m));
  }
  __syncthreads();
  if (threadIdx.x < a.rows)
    sx[threadIdx.x] = __fdiv_rn(fmaxf(__int_as_float(smax[threadIdx.x]), 1e-12f), 127.0f);
  __syncthreads();

  // Quad i: row r, local k 4 j .. 4 j + 3 of the range. The padding rows
  // of the last 16-row tile are left as they are: the mma keeps rows apart,
  // and their sums are never read.
  const int nq = a.split_rows / 4;
  const bool vec4 = ((uintptr_t)x & 15) == 0 && a.K % 4 == 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < a.rows * nq; i += kThreads) {
    const int r = i / nq, kl = 4 * (i - r * nq);
    const int k = p_begin + kl;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (k < p_end) {
      if (vec4) {
        Quad<T>::unpack(__ldg(reinterpret_cast<const typename Quad<T>::V*>(
                            x + (int64_t)r * a.K + k)), f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < p_end) f[e] = to_f32(x[(int64_t)r * a.K + k + e]);
      }
    }
    int8_t* row = xq + r * ld + (kl & ~31);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = rintf(__fdiv_rn(f[e], sx[r]));
      row[frag_pos((kl & 31) + e)] = (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
    }
  }
}

// The w8a8 body: per-channel INT8 weights, all the call's rows (MT 16-row
// tiles, 1 <= rows <= 16 MT) in one block against one pass over a 128-
// column weight tile; grid (column tiles, K splits). Three blocks per SM
// up to 16 rows (the lm_head's 393 column tiles in one wave), two above.
// ALIGNED: every weight row starts on 16 bytes (N % 16 == 0), else each
// 4-byte word is cut from two aligned ones. part (int32, through QArgs's pointer): (splits, column
// tiles, rows, 128) partial sums and tickets: one int32 at 0 per column
// tile, unused when splits == 1.
template <typename T, int MT, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 3 : 2) qmm_w8a8_kernel(const QArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sx[16 * MT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wc = warp & 3, kh = warp >> 2;  // the warp's 32 columns, its k step of a tile
  const int c0 = blockIdx.x * kNT;
  const Tiles<false> tiles(a, smem, c0, blockIdx.y);
  // xq rows of stride ld: (ld / 4) % 32 == 4 words, so the 8 row groups of
  // an A fragment load fall in distinct banks.
  const int m_tiles = (a.rows + 15) / 16;
  const int ld = a.split_rows + 16;
  int8_t* xq = (int8_t*)(smem + kStages * tiles.bytes);
  stage_xq<T>(a, tiles.p_begin, tiles.p_end, xq, ld, sx, [&] {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) tiles.issue(t);
  });

  int acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][c][i] = 0;

  for (int t = 0; t < tiles.ntiles; ++t) {
    tiles.issue(t + kStages - 1);
    zg2::cp_async_wait<kStages - 1>();
    __syncthreads();  // also orders the xq stores before the first tile's reads
    const int p0 = tiles.p_begin + t * kKT;
    if (32 * kh < tiles.p_end - p0) {
      const unsigned char* w = (const unsigned char*)tiles.w(t);
      // B fragments: bq[c][h] is fragment column g of n-tile c, which is
      // the warp's column 4 g + c; h = 0 the step's even rows, 1 the odd.
      uint32_t bq[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t wr[4], col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 32 * kh + 2 * tq + 8 * i + h;
          const unsigned char* row = w + r * kWS + 32 * wc + 4 * g;
          if constexpr (ALIGNED) {
            wr[i] = *reinterpret_cast<const uint32_t*>(row);
          } else {
            const int sh = tiles.shift(p0 + r);
            const uint32_t* p = reinterpret_cast<const uint32_t*>(row + (sh & ~3));
            wr[i] = __funnelshift_r(p[0], p[1], 8 * (sh & 3));
          }
        }
        transpose4(wr, col);
#pragma unroll
        for (int c = 0; c < 4; ++c) bq[c][h] = col[c];
      }
      const int k = p0 - tiles.p_begin + 32 * kh + 4 * tq;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= m_tiles) break;
        const int8_t* xa = xq + (m * 16 + g) * ld + k;
        const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(xa),
                                *reinterpret_cast<const uint32_t*>(xa + 8 * ld),
                                *reinterpret_cast<const uint32_t*>(xa + 16),
                                *reinterpret_cast<const uint32_t*>(xa + 8 * ld + 16)};
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_s8(acc[m][c], af, bq[c]);
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }
  zg2::cp_async_wait<0>();
  __syncthreads();

  // The two k halves' sums, added in shared memory (the stages and xq are
  // free now): red[row][col] over the tile's 128 columns.
  int* red = (int*)smem;
#pragma unroll
  for (int half = 1; half >= 0; --half) {
    if (kh == half) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= m_tiles) break;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 16 * m + g + 8 * (i >> 1);
            const int col = 32 * wc + 4 * (2 * tq + (i & 1)) + c;
            int* at = red + row * kNT + col;
            *at = half ? acc[m][c][i] : *at + acc[m][c][i];
          }
      }
    }
    __syncthreads();
  }

  const int splits = gridDim.y;
  if (splits == 1) {
    for (int o = threadIdx.x; o < a.rows * kNT; o += kThreads) {
      const int r = o / kNT, n = c0 + o % kNT;
      if (n < a.N) a.out[(int64_t)r * a.N + n] = (float)red[o] * sx[r] * a.scale[n];
    }
    return;
  }
  if (a.cluster) {
    // The column tile's splits are one thread-block cluster: block rank q
    // adds every rank's sums for the outputs q, q + splits, ... through
    // distributed shared memory, in rank (split) order, and applies the
    // tail. The second barrier keeps every block's sums alive until read.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int o = threadIdx.x + blockIdx.y * kThreads; o < a.rows * kNT;
         o += splits * kThreads) {
      const int r = o / kNT, n = c0 + o % kNT;
      int v = 0;
      for (int q = 0; q < splits; ++q) v += *cluster.map_shared_rank(red + o, q);
      if (n < a.N) a.out[(int64_t)r * a.N + n] = (float)v * sx[r] * a.scale[n];
    }
    cluster.sync();
    return;
  }
  // This split's sums, as the tile's int4 quads (part is tile-contiguous,
  // so every quad is 16-byte aligned whatever N is).
  const int Q = a.rows * kNT / 4, ntiles = (a.N + kNT - 1) / kNT;
  int4* part = reinterpret_cast<int4*>(a.part);
  int4* mine = part + ((int64_t)blockIdx.y * ntiles + blockIdx.x) * Q;
  for (int q = threadIdx.x; q < Q; q += kThreads) mine[q] = reinterpret_cast<const int4*>(red)[q];
  if (!zg2::last_to_arrive(a.tickets + blockIdx.x, splits)) return;
  // The last block of the column tile: each thread owns up to U of the
  // tile's quads and sums their splits in split order (integer sums: exact
  // in any order), U * kZ 16-byte loads in flight, then applies the tail
  // float(acc) * sx[r] * scale[n] in the plain version's order.
  constexpr int U = 2 * MT;       // quads per thread: Q <= 16 MT * kNT / 4
  constexpr int kZ = 16 / U;      // splits per batch
  int4 sum[U];
#pragma unroll
  for (int u = 0; u < U; ++u) sum[u] = make_int4(0, 0, 0, 0);
  for (int z0 = 0; z0 < splits; z0 += kZ) {
    int4 v[kZ][U];
#pragma unroll
    for (int z = 0; z < kZ; ++z)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = threadIdx.x + u * kThreads;
        v[z][u] = q < Q && z0 + z < splits
                      ? __ldcg(part + ((int64_t)(z0 + z) * ntiles + blockIdx.x) * Q + q)
                      : make_int4(0, 0, 0, 0);
      }
#pragma unroll
    for (int z = 0; z < kZ; ++z)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sum[u].x += v[z][u].x;
        sum[u].y += v[z][u].y;
        sum[u].z += v[z][u].z;
        sum[u].w += v[z][u].w;
      }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q >= Q) continue;
    const int r = 4 * q / kNT, c = 4 * q % kNT;
    const int s4[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = c0 + c + e;
      if (n < a.N) a.out[(int64_t)r * a.N + n] = (float)s4[e] * sx[r] * a.scale[n];
    }
  }
}

// Rows per w8a8 block: 16 up to 16 rows, 32 up to 32, else 64.
__host__ __device__ __forceinline__ int w8a8_m_tiles(int rows) {
  return rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
}

template <typename T, int MT>
cudaError_t launch_w8a8(const QArgs& a, int splits, bool aligned, cudaStream_t stream) {
  const int x_bytes = 16 * MT * (a.split_rows + 16);
  if (x_bytes > (MT == 1 ? kW8XBytes : kW8XBytesWide)) return cudaErrorInvalidValue;
  int smem = kStages * stage_bytes(false, a.K, a.K) + x_bytes;
  if (smem < 16 * MT * kNT * 4) smem = 16 * MT * kNT * 4;  // the halves' reduction
  const dim3 grid((a.N + kNT - 1) / kNT, splits);
  const int cluster = a.cluster ? splits : 1;
  if (aligned)
    return launch_kernel<qmm_w8a8_kernel<T, MT, true>>(grid, smem, a, stream, cluster);
  return launch_kernel<qmm_w8a8_kernel<T, MT, false>>(grid, smem, a, stream, cluster);
}

template <typename T>
cudaError_t dispatch_w8a8(const QArgs& a, int splits, bool aligned, cudaStream_t stream) {
  switch (w8a8_m_tiles(a.rows)) {
    case 1: return launch_w8a8<T, 1>(a, splits, aligned, stream);
    case 2: return launch_w8a8<T, 2>(a, splits, aligned, stream);
    default: return launch_w8a8<T, 4>(a, splits, aligned, stream);
  }
}

}  // namespace

// The weight-only body. dtype code of x: 0 = float32, 1 = bfloat16. G: rows
// per scale group (K for per-channel). splits x split_rows: the K split
// (packed rows; split_rows a multiple of 64 and the splits covering K or
// K/2 with none empty); row_tile: the rows per block, which must be the
// body's (1 or 4 for the CUDA cores, 16 or 64 for the tensor cores). part:
// (splits, rows, N) f32 scratch and tickets: one int32 at 0 per (row tile,
// column tile of 128), unused when splits == 1. Returns a cudaError_t.
extern "C" int zg2_qmm(const void* x, const void* qw, const void* scale, void* part,
                       void* tickets, void* out, int rows, int K, int N, int G, int splits,
                       int split_rows, int rtile, int int4, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || K < 1 || N < 1 || G < 1 || K % G || (int4 && K % 2) || splits < 1 ||
      split_rows < kKT || split_rows % kKT || (splits > 1 && (!part || !tickets)))
    return cudaErrorInvalidValue;
  const int P = int4 ? K / 2 : K;
  if ((int64_t)splits * split_rows < P || (int64_t)(splits - 1) * split_rows >= P)
    return cudaErrorInvalidValue;
  const QArgs a{x, (const int8_t*)qw, (const float*)scale, (float*)part, (int*)tickets,
                (float*)out, rows, K, N, G, split_rows};
  if (dtype == 0 && rtile == row_tile<float>(rows))
    return dispatch<float>(a, splits, int4, st);
  if (dtype == 1 && rtile == row_tile<__nv_bfloat16>(rows))
    return dispatch<__nv_bfloat16>(a, splits, int4, st);
  return cudaErrorInvalidValue;
}

// The w8a8 body: x (rows, K) f32 (dtype 0) or bf16 (1), 1 <= rows <= 64;
// qw (K, N) int8; scale (1, N) f32. splits x split_rows: the K split
// (split_rows a multiple of 64, the splits covering K with none empty);
// m_tiles: the body's 16-row tiles, which must be w8a8_m_tiles(rows);
// cluster: 1 to combine the splits (2 to 8 of them) of a column tile in one
// thread-block cluster, 0 for the ticket. part: (splits, column tiles of
// 128, rows, 128) int32 scratch and tickets: one int32 at 0 per column
// tile, unused when splits == 1 or with a cluster. Returns a cudaError_t.
extern "C" int zg2_qmm_w8a8(const void* x, const void* qw, const void* scale, void* part,
                            void* tickets, void* out, int rows, int K, int N, int splits,
                            int split_rows, int m_tiles, int cluster, int dtype,
                            void* stream) {
  if (rows < 1 || rows > 64 || K < 1 || N < 1 || splits < 1 || split_rows < kKT ||
      split_rows % kKT || m_tiles != w8a8_m_tiles(rows) ||
      (int64_t)splits * split_rows < K || (int64_t)(splits - 1) * split_rows >= K ||
      (cluster && (splits < 2 || splits > 8)) ||
      (splits > 1 && !cluster && (!part || !tickets)))
    return cudaErrorInvalidValue;
  const QArgs a{x, (const int8_t*)qw, (const float*)scale, (float*)part, (int*)tickets,
                (float*)out, rows, K, N, K, split_rows, cluster != 0};
  const bool aligned = N % 16 == 0 && ((uintptr_t)qw & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_w8a8<float>(a, splits, aligned, st);
  if (dtype == 1) return dispatch_w8a8<__nv_bfloat16>(a, splits, aligned, st);
  return cudaErrorInvalidValue;
}
