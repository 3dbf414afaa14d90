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
// Bound on the H100: device-memory bytes. A decode call (rows = 1) reads
// each weight byte once and does 2 operations per weight, about 4 per byte
// at INT4; that is far below the ~20 flops per byte where the f32 units
// would become the limit. At GPT-2 1.5B: c_fc is a 5.12 MB INT4 tile plus
// 1.28 MB of scales, 1.9 us at 3.35 TB/s; the INT8 lm_head is 80.4 MB,
// 24 us; a w8a8 c_fc is 10.24 MB, 3.1 us, and a w8a8 B=1 step's 289 GEMVs
// about 1.58 GB, 0.47 ms. (At 16-64 rows the w8a8 body's int32
// multiply-adds, one instruction per product, would bound it before the
// bytes; the int8 tensor cores would not.)
//
// Design against that bound: one thread per output column, so a warp reads
// 32 neighbouring bytes of a weight row at once (one 32-byte sector); the
// loop over K is unrolled so that each thread keeps eight row loads in
// flight. The activations of the block's rows are staged in shared memory
// kChunk packed rows at a time and read by all threads as a broadcast (for
// w8a8 already quantized, as int). A thread keeps RT row accumulators in
// registers (RT = 1 for a single row, else 8 with the rows tiled over
// gridDim.y). To fill 132 SMs when N is small (1600 columns is 13 blocks),
// gridDim.z splits the K range; each split writes its partial sums (f32,
// or int32 for w8a8) and a second pass adds the splits in order and
// applies the per-channel scale (and for w8a8 the row scales, which block
// (0, y, 0) stores), so the result does not depend on the launch. Every
// w8a8 block first reduces its rows' absmax over the whole of K (the TPU
// kernel likewise quantizes x in every program): rows x K reads from L2,
// against K x 128 weight bytes per block, and no extra launch.
//
// What it leaves to a later PR: byte loads give each warp only 32 bytes per
// load in flight, and the partial sums of a split launch add traffic. Four
// columns per thread with 32-bit loads (N % 4 == 0 for every block linear),
// __dp4a or the int8 tensor cores (mma.sync s8) for w8a8, wider rows on the
// tensor cores for prefill, and one launch per layer for the three
// projections are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // threads per block: one output column each
constexpr int kChunk = 64;  // packed weight rows per shared-memory stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The dequantized weight rounded to the activation dtype.
__device__ __forceinline__ float round_as(float w, const float*) { return w; }
__device__ __forceinline__ float round_as(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(w));
}

// Sign-extends the low nibble of v.
__device__ __forceinline__ int nibble(int v) { return ((v & 15) ^ 8) - 8; }

// T: activation type. INT4: qw holds the half-split pack. PER_CHANNEL: one
// scale group (G == K). RT: rows per thread.
template <typename T, bool INT4, bool PER_CHANNEL, int RT>
__global__ void __launch_bounds__(kCols)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
           const float* __restrict__ scale, float* __restrict__ part,
           int rows, int K, int N, int G, int split_rows) {
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int r0 = blockIdx.y * RT;
  const int half = K / 2;
  const int P = INT4 ? half : K;  // packed weight rows
  const int p_begin = blockIdx.z * split_rows;
  const int p_end = min(P, p_begin + split_rows);
  const bool live = n < N;

  // x[r0 + r, p] for the stage's packed rows p; for INT4 also x[r0 + r, p + K/2].
  __shared__ float xs[RT][INT4 ? 2 * kChunk : kChunk];

  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;

  // Grouped scales: the current group of the low (and high) row, reloaded
  // when the row crosses a group boundary (uniform over the block).
  int g_lo = p_begin / G, g_hi = (p_begin + half) / G;
  int next_lo = (g_lo + 1) * G, next_hi = (g_hi + 1) * G;
  float s_lo = 0.f, s_hi = 0.f;
  if (!PER_CHANNEL && live && p_begin < p_end) {
    s_lo = scale[(int64_t)g_lo * N + n];
    if (INT4) s_hi = scale[(int64_t)g_hi * N + n];
  }

  for (int pc = p_begin; pc < p_end; pc += kChunk) {
    const int len = min(kChunk, p_end - pc);
    __syncthreads();  // the previous stage's reads are done
    for (int i = threadIdx.x; i < RT * len; i += kCols) {
      const int r = i / len, c = i - r * len;
      const bool ok = r0 + r < rows;
      const int64_t xo = (int64_t)(r0 + r) * K + pc + c;
      xs[r][c] = ok ? to_f32(x[xo]) : 0.f;
      if (INT4) xs[r][kChunk + c] = ok ? to_f32(x[xo + half]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int8_t* wp = qw + (int64_t)pc * N + n;
#pragma unroll 8
    for (int c = 0; c < len; ++c) {
      const int b = wp[(int64_t)c * N];
      const int p = pc + c;
      float w_lo = (float)(INT4 ? nibble(b) : b);
      float w_hi = INT4 ? (float)nibble(b >> 4) : 0.f;
      if (!PER_CHANNEL) {
        if (p == next_lo) {
          ++g_lo;
          next_lo += G;
          s_lo = scale[(int64_t)g_lo * N + n];
        }
        w_lo = round_as(w_lo * s_lo, x);
        if (INT4) {
          if (p + half == next_hi) {
            ++g_hi;
            next_hi += G;
            s_hi = scale[(int64_t)g_hi * N + n];
          }
          w_hi = round_as(w_hi * s_hi, x);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc[r] += xs[r][c] * w_lo;
        if (INT4) acc[r] += xs[r][kChunk + c] * w_hi;
      }
    }
  }
  if (!live) return;
  // One split: the final result. Several: this split's partial sums.
  const float s = (PER_CHANNEL && gridDim.z == 1) ? scale[n] : 1.f;
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (r0 + r < rows)
      part[((int64_t)blockIdx.z * rows + r0 + r) * N + n] = acc[r] * s;
}

// out[r, n] = sum over splits in order, times the per-channel scale.
template <bool PER_CHANNEL>
__global__ void qmm_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, int rows, int N,
                                  int splits) {
  const int64_t total = (int64_t)rows * N;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * total + i];
  out[i] = PER_CHANNEL ? s * scale[i % N] : s;
}

template <typename T, bool INT4, bool PER_CHANNEL>
cudaError_t launch(const void* x, const void* qw, const void* scale, void* part,
                   void* out, int rows, int K, int N, int G, int splits,
                   cudaStream_t stream) {
  const int P = INT4 ? K / 2 : K;
  const int split_rows = (P + splits - 1) / splits;
  const int rt = rows == 1 ? 1 : 8;
  const dim3 grid((N + kCols - 1) / kCols, (rows + rt - 1) / rt, splits);
  float* dst = (float*)(splits == 1 ? out : part);
  if (rt == 1)
    qmm_kernel<T, INT4, PER_CHANNEL, 1><<<grid, kCols, 0, stream>>>(
        (const T*)x, (const int8_t*)qw, (const float*)scale, dst, rows, K, N, G,
        split_rows);
  else
    qmm_kernel<T, INT4, PER_CHANNEL, 8><<<grid, kCols, 0, stream>>>(
        (const T*)x, (const int8_t*)qw, (const float*)scale, dst, rows, K, N, G,
        split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = (int64_t)rows * N;
  qmm_reduce_kernel<PER_CHANNEL><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (const float*)scale, (float*)out, rows, N, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* qw, const void* scale, void* part,
                     void* out, int rows, int K, int N, int G, int splits, int int4,
                     cudaStream_t stream) {
  const bool per_channel = G == K;
  if (int4)
    return per_channel
        ? launch<T, true, true>(x, qw, scale, part, out, rows, K, N, G, splits, stream)
        : launch<T, true, false>(x, qw, scale, part, out, rows, K, N, G, splits, stream);
  return per_channel
      ? launch<T, false, true>(x, qw, scale, part, out, rows, K, N, G, splits, stream)
      : launch<T, false, false>(x, qw, scale, part, out, rows, K, N, G, splits, stream);
}

// The w8a8 body: per-channel INT8 weights, x quantized per row. RT: rows
// per thread. part: int32 partial sums of a split launch; sx_out: the row
// scales for its reduce pass; out: the result of a one-split launch.
template <typename T, int RT>
__global__ void __launch_bounds__(kCols)
qmm_w8a8_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                const float* __restrict__ scale, int32_t* __restrict__ part,
                float* __restrict__ sx_out, float* __restrict__ out, int rows,
                int K, int N, int split_rows) {
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int r0 = blockIdx.y * RT;
  const int k_begin = blockIdx.z * split_rows;
  const int k_end = min(K, k_begin + split_rows);
  const bool live = n < N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  __shared__ float red[kCols / 32][RT];
  __shared__ float sx[RT];
  __shared__ int xs[RT][kChunk];  // xq[r0 + r, k] for the stage's rows k

  // Each row's scale from its absmax over the whole of K (max is exact in
  // any order).
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float m = 0.f;
    if (r0 + r < rows) {
      const T* xr = x + (int64_t)(r0 + r) * K;
      for (int k = threadIdx.x; k < K; k += kCols) m = fmaxf(m, fabsf(to_f32(xr[k])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[warp][r] = m;
  }
  __syncthreads();
  if (threadIdx.x < RT) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kCols / 32; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    sx[threadIdx.x] = fmaxf(m, 1e-12f) / 127.0f;
  }
  __syncthreads();

  int acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0;

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    const int len = min(kChunk, k_end - kc);
    __syncthreads();  // the previous stage's reads are done
    for (int i = threadIdx.x; i < RT * len; i += kCols) {
      const int r = i / len, c = i - r * len;
      int v = 0;
      if (r0 + r < rows) {
        const float q = rintf(to_f32(x[(int64_t)(r0 + r) * K + kc + c]) / sx[r]);
        v = (int)fminf(fmaxf(q, -127.f), 127.f);
      }
      xs[r][c] = v;
    }
    __syncthreads();
    if (!live) continue;
    const int8_t* wp = qw + (int64_t)kc * N + n;
#pragma unroll 8
    for (int c = 0; c < len; ++c) {
      const int b = wp[(int64_t)c * N];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] += xs[r][c] * b;
    }
  }
  const bool split = gridDim.z > 1;
  if (split && blockIdx.x == 0 && blockIdx.z == 0 && threadIdx.x < RT &&
      r0 + threadIdx.x < rows)
    sx_out[r0 + threadIdx.x] = sx[threadIdx.x];
  if (!live) return;
  const float s = scale[n];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r0 + r >= rows) continue;
    if (split)
      part[((int64_t)blockIdx.z * rows + r0 + r) * N + n] = acc[r];
    else
      out[(int64_t)(r0 + r) * N + n] = (float)acc[r] * sx[r] * s;
  }
}

// out[r, n] = float(sum over splits) * sx[r] * scale[n]: int32 sums are
// exact in any order.
__global__ void qmm_w8a8_reduce_kernel(const int32_t* __restrict__ part,
                                       const float* __restrict__ sx,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, int rows, int N,
                                       int splits) {
  const int64_t total = (int64_t)rows * N;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int s = 0;
  for (int z = 0; z < splits; ++z) s += part[z * total + i];
  out[i] = (float)s * sx[i / N] * scale[i % N];
}

template <typename T>
cudaError_t launch_w8a8(const void* x, const void* qw, const void* scale, void* part,
                        void* sx, void* out, int rows, int K, int N, int splits,
                        cudaStream_t stream) {
  const int split_rows = (K + splits - 1) / splits;
  const int rt = rows == 1 ? 1 : 8;
  const dim3 grid((N + kCols - 1) / kCols, (rows + rt - 1) / rt, splits);
  if (rt == 1)
    qmm_w8a8_kernel<T, 1><<<grid, kCols, 0, stream>>>(
        (const T*)x, (const int8_t*)qw, (const float*)scale, (int32_t*)part,
        (float*)sx, (float*)out, rows, K, N, split_rows);
  else
    qmm_w8a8_kernel<T, 8><<<grid, kCols, 0, stream>>>(
        (const T*)x, (const int8_t*)qw, (const float*)scale, (int32_t*)part,
        (float*)sx, (float*)out, rows, K, N, split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = (int64_t)rows * N;
  qmm_w8a8_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const int32_t*)part, (const float*)sx, (const float*)scale, (float*)out, rows,
      N, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype code of x: 0 = float32, 1 = bfloat16. G: rows per scale group (K
// for per-channel). part: (splits, rows, N) f32 scratch, unused when
// splits == 1. Returns a cudaError_t.
extern "C" int zg2_qmm(const void* x, const void* qw, const void* scale,
                       void* part, void* out, int rows, int K, int N, int G,
                       int splits, int int4, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || K < 1 || N < 1 || G < 1 || K % G || splits < 1 || (int4 && K % 2))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(x, qw, scale, part, out, rows, K, N, G, splits, int4, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, qw, scale, part, out, rows, K, N, G, splits,
                                   int4, st);
  return cudaErrorInvalidValue;
}

// The w8a8 body: x (rows, K) f32 (dtype 0) or bf16 (1), 1 <= rows <= 64;
// qw (K, N) int8; scale (1, N) f32. part: (splits, rows, N) int32 and sx:
// (rows,) f32 scratch, unused when splits == 1. Returns a cudaError_t.
extern "C" int zg2_qmm_w8a8(const void* x, const void* qw, const void* scale,
                            void* part, void* sx, void* out, int rows, int K, int N,
                            int splits, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || rows > 64 || K < 1 || N < 1 || splits < 1)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_w8a8<float>(x, qw, scale, part, sx, out, rows, K, N, splits, st);
  if (dtype == 1)
    return launch_w8a8<__nv_bfloat16>(x, qw, scale, part, sx, out, rows, K, N, splits,
                                      st);
  return cudaErrorInvalidValue;
}
