// Gumbel-max categorical sampler for Hopper (sm_90a).
//
// Replaces: zig_gpt2_tpu/ops/sampling_kernel.py, sample_categorical (the
// kernel body inside it, with its return_max output). Per row b of (B, V)
// logits:
//
//   u_j = float(0x3F800000 | (philox(j; seeds[b], b).x >> 9)) - 1   in [0, 1)
//   g_j = -log(-log(u_j + 1e-20) + 1e-20)
//   z_j = logit_j * (1 / T) + g_j,   z_j = -inf where logit_j < thresh[b]
//   out[b] = the smallest j with z_j == max z,   zmax[b] = max z (return_max)
//
// The noise is counter-based Philox4x32-10 keyed by (seeds[b], b) with the
// vocab index as counter, so the plain PyTorch version in sampling_kernel.py
// reproduces it bit for bit and the two agree on every id. It does not
// reproduce the TPU kernel's hardware PRNG stream, which no other device can.
// The multiply and add of z are written as __fmul_rn / __fadd_rn so that the
// compiler does not fuse them into one FMA that the plain version lacks.
//
// Bound on the H100: at B = 1 and V = 50257 a call reads 201 KB of logits
// (0.06 us at 3.35 TB/s) and does about 114 32-bit operations per element
// (Philox's ten rounds, two logs), 5.7 M in all (0.09 us at 67 TOP/s).
// Either is far below a kernel launch, so launch latency bounds it, once
// the work is spread over the card.
//
// Design against that bound: one launch for the whole batch, grid (splits,
// B). The row is cut into contiguous chunks of a size that depends on (B, V)
// only (ops/sampling_kernel.py sampler_geometry: about two blocks per SM),
// so at B = 1 some 200 SMs' worth of blocks share the Philox and log work
// that one block did before. Each block reads its chunk 16 bytes per lane
// where the row is aligned (a row b >= 1 of V = 50257 is not: a scalar head
// and tail), keeps each thread's best (z, id), and reduces them by warp
// shuffle and shared memory. With one split that block writes the result.
// Otherwise it writes its pair, takes a ticket from the row's self-
// resetting counter (zg2::last_to_arrive), and the row's last block reduces
// the pairs, read by split index. "Larger z, then smaller id" is a total
// order, so the winner does not depend on the order in which blocks arrive
// or pairs are reduced: ids and z* are the plain version's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Philox4x32-10 (Salmon et al., SC'11); returns the first output word.
__device__ __forceinline__ uint32_t philox_x0(uint32_t c0, uint32_t k0, uint32_t k1) {
  uint32_t c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// True when (z, i) beats (zb, ib): larger z, or equal z and smaller id.
__device__ __forceinline__ bool better(float z, int i, float zb, int ib) {
  return z > zb || (z == zb && i < ib);
}

// The running best (z, id) of one thread. A thread whose every element was
// masked keeps (-inf, V): it never wins against a kept element, whose z is
// finite.
struct Best {
  float z;
  int id;
  __device__ __forceinline__ void take(float zc, int ic) {
    if (better(zc, ic, z, id)) {
      z = zc;
      id = ic;
    }
  }
};

struct Row {
  uint32_t k0, k1;
  float th, inv_t;
  // Element j of the row with logit xv.
  __device__ __forceinline__ void visit(Best& best, int j, float xv) const {
    const uint32_t bits = philox_x0((uint32_t)j, k0, k1);
    const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    const float g = -logf(__fadd_rn(-logf(__fadd_rn(u, 1e-20f)), 1e-20f));
    float z = __fadd_rn(__fmul_rn(xv, inv_t), g);
    if (xv < th) z = -INFINITY;
    best.take(z, j);
  }
};

// The block's best pair, in thread 0. Call from every thread.
__device__ __forceinline__ void block_best(Best& best) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best.take(__shfl_xor_sync(0xffffffffu, best.z, o),
              __shfl_xor_sync(0xffffffffu, best.id, o));
  __shared__ float sm_z[kWarps];
  __shared__ int sm_i[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // an earlier call's reads are done
  if (lane == 0) {
    sm_z[warp] = best.z;
    sm_i[warp] = best.id;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) best.take(sm_z[w], sm_i[w]);
}

// Block (s, b) samples ids [s * chunk, min(V, (s + 1) * chunk)) of row b.
// part_z / part_i: (B, splits) pairs and tickets: one int32 at 0 per row,
// unused with one split. zmax may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_categorical_kernel(const T* __restrict__ logits, const int32_t* __restrict__ seeds,
                          const float* __restrict__ thresh, int32_t* __restrict__ out,
                          float* __restrict__ zmax, float* __restrict__ part_z,
                          int32_t* __restrict__ part_i, int* __restrict__ tickets, int V,
                          int chunk, float inv_t) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  const int s = blockIdx.x, b = blockIdx.y, splits = gridDim.x;
  const int lo = s * chunk, hi = min(V, lo + chunk);
  const T* x = logits + (int64_t)b * V;
  const Row row{(uint32_t)seeds[b], (uint32_t)b, thresh != nullptr ? thresh[b] : -INFINITY,
                inv_t};

  // A scalar head up to the first 16-byte boundary, 16-byte loads, a
  // scalar tail.
  const int head = min(hi - lo, (int)(((16 - ((uintptr_t)(x + lo) & 15)) & 15) / sizeof(T)));
  const int nvec = (hi - lo - head) / E;
  const int tail = lo + head + nvec * E;
  Best best{-INFINITY, V};
  for (int j = lo + threadIdx.x; j < lo + head; j += kThreads) row.visit(best, j, to_f32(x[j]));
  const uint4* xv = reinterpret_cast<const uint4*>(x + lo + head);
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const uint4 w = __ldg(xv + v);
    const T* e = reinterpret_cast<const T*>(&w);
    const int j0 = lo + head + v * E;
#pragma unroll
    for (int k = 0; k < E; ++k) row.visit(best, j0 + k, to_f32(e[k]));
  }
  for (int j = tail + threadIdx.x; j < hi; j += kThreads) row.visit(best, j, to_f32(x[j]));
  block_best(best);

  if (splits == 1) {
    if (threadIdx.x == 0) {
      out[b] = best.id;
      if (zmax != nullptr) zmax[b] = best.z;
    }
    return;
  }
  if (threadIdx.x == 0) {
    part_z[(int64_t)b * splits + s] = best.z;
    part_i[(int64_t)b * splits + s] = best.id;
  }
  if (!zg2::last_to_arrive(tickets + b, splits)) return;
  best = Best{-INFINITY, V};
  for (int i = threadIdx.x; i < splits; i += kThreads)
    best.take(__ldcg(part_z + (int64_t)b * splits + i), __ldcg(part_i + (int64_t)b * splits + i));
  block_best(best);
  if (threadIdx.x == 0) {
    out[b] = best.id;
    if (zmax != nullptr) zmax[b] = best.z;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const void* seeds, const void* thresh, void* out,
                   void* zmax, void* part_z, void* part_i, void* tickets, int B, int V,
                   int splits, int chunk, float inv_t, cudaStream_t stream) {
  sample_categorical_kernel<T><<<dim3(splits, B), kThreads, 0, stream>>>(
      (const T*)logits, (const int32_t*)seeds, (const float*)thresh, (int32_t*)out,
      (float*)zmax, (float*)part_z, (int32_t*)part_i, (int*)tickets, V, chunk, inv_t);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. thresh and zmax may be null.
// splits x chunk: the vocab split (chunk ids per block, the splits covering
// V with none empty); part_z (B, splits) f32, part_i (B, splits) int32 and
// tickets (B int32 at 0) are unused when splits == 1. Returns a cudaError_t.
extern "C" int zg2_sample_categorical(const void* logits, const void* seeds,
                                      const void* thresh, void* out, void* zmax,
                                      void* part_z, void* part_i, void* tickets, int B,
                                      int V, int splits, int chunk, float inv_t, int dtype,
                                      void* stream) {
  if (B < 1 || B > 65535 || V < 1 || splits < 1 || chunk < 1 ||
      (int64_t)splits * chunk < V || (int64_t)(splits - 1) * chunk >= V ||
      (splits > 1 && (!part_z || !part_i || !tickets)))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(logits, seeds, thresh, out, zmax, part_z, part_i, tickets, B, V,
                         splits, chunk, inv_t, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, seeds, thresh, out, zmax, part_z, part_i, tickets,
                                 B, V, splits, chunk, inv_t, st);
  return cudaErrorInvalidValue;
}
