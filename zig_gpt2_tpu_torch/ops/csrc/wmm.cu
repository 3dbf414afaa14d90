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
// the limit. At GPT-2 124M a layer's six block linears are 7.08 M weights,
// 28.3 MB in f32: 72 calls per B=1 decode step move 340 MB, 0.10 ms at
// 3.35 TB/s (0.05 ms in bf16).
//
// Design against that bound, the layout of qmm.cu: one thread per output
// column, so a warp reads 128 (f32) or 64 (bf16) neighbouring bytes of a
// weight row at once; the loop over K is unrolled so that each thread keeps
// eight row loads in flight. The block's rows of x are staged in shared
// memory kChunk rows at a time and read by all threads as a broadcast. A
// thread keeps RT row accumulators (RT = 1 for a single row, else 8 with
// the rows tiled over gridDim.y). gridDim.z splits K when N alone would
// not fill the 132 SMs (768 columns is 6 blocks); each split writes its f32
// partial sums and a second pass adds them in order, so the result does
// not depend on the launch.
//
// What it leaves to a later PR: one weight element per thread per row
// (4 or 2 bytes a load); wider loads (four columns per thread), the bf16
// tensor cores for rows >= 16, and one launch for the three Q/K/V
// projections.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // threads per block: one output column each
constexpr int kChunk = 64;  // weight rows per shared-memory stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The weight rounded to the activation dtype.
__device__ __forceinline__ float round_as(float w, const float*) { return w; }
__device__ __forceinline__ float round_as(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(w));
}

// TX: activation type, TW: weight type, RT: rows per thread.
template <typename TX, typename TW, int RT>
__global__ void __launch_bounds__(kCols)
wmm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
           float* __restrict__ part, int rows, int K, int N, int split_rows) {
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int r0 = blockIdx.y * RT;
  const int k_begin = blockIdx.z * split_rows;
  const int k_end = min(K, k_begin + split_rows);
  const bool live = n < N;

  __shared__ float xs[RT][kChunk];

  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    const int len = min(kChunk, k_end - kc);
    __syncthreads();  // the previous stage's reads are done
    for (int i = threadIdx.x; i < RT * len; i += kCols) {
      const int r = i / len, c = i - r * len;
      xs[r][c] = r0 + r < rows ? to_f32(x[(int64_t)(r0 + r) * K + kc + c]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const TW* wp = w + (int64_t)kc * N + n;
#pragma unroll 8
    for (int c = 0; c < len; ++c) {
      const float wv = round_as(to_f32(wp[(int64_t)c * N]), x);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] += xs[r][c] * wv;
    }
  }
  if (!live) return;
  // One split: the final result. Several: this split's partial sums.
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (r0 + r < rows)
      part[((int64_t)blockIdx.z * rows + r0 + r) * N + n] = acc[r];
}

// out[r, n] = sum over splits, in order.
__global__ void wmm_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int rows, int N, int splits) {
  const int64_t total = (int64_t)rows * N;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * total + i];
  out[i] = s;
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* part, void* out, int rows, int K,
                   int N, int splits, cudaStream_t stream) {
  const int split_rows = (K + splits - 1) / splits;
  const int rt = rows == 1 ? 1 : 8;
  const dim3 grid((N + kCols - 1) / kCols, (rows + rt - 1) / rt, splits);
  float* dst = (float*)(splits == 1 ? out : part);
  if (rt == 1)
    wmm_kernel<TX, TW, 1><<<grid, kCols, 0, stream>>>((const TX*)x, (const TW*)w, dst,
                                                      rows, K, N, split_rows);
  else
    wmm_kernel<TX, TW, 8><<<grid, kCols, 0, stream>>>((const TX*)x, (const TW*)w, dst,
                                                      rows, K, N, split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = (int64_t)rows * N;
  wmm_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (float*)out, rows, N, splits);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch(const void* x, const void* w, void* part, void* out, int rows, int K,
                     int N, int splits, int wdtype, cudaStream_t stream) {
  if (wdtype == 0) return launch<TX, float>(x, w, part, out, rows, K, N, splits, stream);
  if (wdtype == 1)
    return launch<TX, __nv_bfloat16>(x, w, part, out, rows, K, N, splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes of x and w: 0 = float32, 1 = bfloat16. part: (splits, rows, N)
// f32 scratch, unused when splits == 1. Returns a cudaError_t.
extern "C" int zg2_wmm(const void* x, const void* w, void* part, void* out, int rows,
                       int K, int N, int splits, int xdtype, int wdtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || rows > 256 || K < 1 || N < 1 || splits < 1) return cudaErrorInvalidValue;
  if (xdtype == 0) return dispatch<float>(x, w, part, out, rows, K, N, splits, wdtype, st);
  if (xdtype == 1)
    return dispatch<__nv_bfloat16>(x, w, part, out, rows, K, N, splits, wdtype, st);
  return cudaErrorInvalidValue;
}
