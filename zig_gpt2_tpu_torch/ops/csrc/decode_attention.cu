// Deferred-append single-query decode attention for Hopper (sm_90a), over a
// float cache or an INT8 cache.
//
// Replaces: zig_gpt2_tpu/ops/attention.py, decode_attention_deferred_fused
// and decode_attention_quant_deferred_fused (body _build_kernel, unpacked),
// with the prefix mask and with the ring interval (start=). Same contract:
// q, k_new, v_new (B, H, D); stacked caches (L, B, H, S, D); length (B,)
// int32; layer index; for the ring variant start (B,) int32. Output
// (B, H, D) in q's dtype:
//
//   softmax over {q.k_new * scale} U {q.k_cache[layer, b, h, row(i)] * scale : i < length[b]}
//   applied to {v_new} U {v_cache[layer, b, h, row(i)]}
//
// with row(i) = i (prefix) or (start[b] + i) mod S (ring: the serving ring
// cache keeps a lane's rows in the interval [start, start + length) mod S).
//
// The running max, denominator and V accumulator are f32 and are seeded with
// the self-term exactly as the TPU kernel seeds them (m = q.k_new * scale,
// den = 1, acc = v_new). Rows outside a lane's length rows are never read:
// they hold stale data and, in the deferred order, the row being appended
// this step.
//
// Ring (RING): the block walks the logical rows i in [0, len) in the same
// order, with the same warp and tile split, as the prefix kernel, and reads
// physical row (start + i) mod S, computed per row since a tile may straddle
// the wrap. So a ring lane reads exactly the bytes a prefix lane of the same
// length reads (no mask scan over S), and a ring cache that holds a linear
// cache's rows rotated by start gives a bit-identical result.
//
// INT8 cache (QUANT): k_new, v_new and the caches are int8, with f32 scales
// ks_new, vs_new (B, H) and planes k_scale, v_scale (L, B, H, S) read at the
// cache's (layer, b, h) offset. Dequantization is folded into the softmax,
// all in f32: a row's score is (q.k[s]) * scale * k_scale[s]; e = exp(s - m)
// goes into den, and e * v_scale[s] weights v[s] in acc (V scales never
// enter the denominator). The self-term seeds m = (q.k_new) * scale * ks_new
// and acc = v_new * vs_new.
//
// Bound on the H100: device-memory bytes. One call reads 2 * B * H * len * D
// cache elements (plus 2 * B * H * len scales for INT8) and does about 4
// flops per element read, far below the ~20 flops per byte where the f32
// (non-tensor) units would become the limit. At GPT-2 124M (H=12, D=64),
// len 1024, f32: 6.3 MB, 1.9 us at 3.35 TB/s. At GPT-2 1.5B INT8 (H=25,
// D=64), len 1023, B=1: 3.3 MB of int8 plus 0.2 MB of scales, 1.0 us.
//
// Design against that bound: one block per (b, h) reads its layer slice by
// pointer offset ((layer * B + b) * H + h) * S * D, so no slice is copied.
// Eight warps each take tiles of ROWS consecutive rows; a tile's K and V rows
// (and scales) are all loaded before any arithmetic so that every warp keeps
// ROWS row loads in flight, and each lane reads D / 32 neighbouring elements
// so a warp's row load is one contiguous segment. Each warp keeps its own
// online softmax state; the eight states are merged once through shared
// memory.
//
// What it leaves to a later PR: the grid is B * H blocks, 12 at 124M and 25
// at 1.5B for B = 1 (400 at 1.5B for the batcher's B = 16), so at B = 1 most
// of the 132 SMs idle and one block's latency sets the time (an INT8 row is 64 bytes, 2 bytes per lane: the loads are
// narrow too). The fix is a split-S flash-decode: several blocks per
// (b, h), each over a range of rows, and a combine pass over their
// (m, den, acc) partials.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;  // rows per warp tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// T: type of q and out. C: type of k_new, v_new and the caches (T, or int8_t
// when QUANT). RING: read the interval from start (else start is unused).
// DPL: D / 32.
template <typename T, typename C, bool QUANT, bool RING, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_deferred_kernel(const T* __restrict__ q,
                                 const C* __restrict__ k_new,
                                 const float* __restrict__ ks_new,
                                 const C* __restrict__ v_new,
                                 const float* __restrict__ vs_new,
                                 const C* __restrict__ k_cache,
                                 const float* __restrict__ k_scale,
                                 const C* __restrict__ v_cache,
                                 const float* __restrict__ v_scale,
                                 const int32_t* __restrict__ length,
                                 const int32_t* __restrict__ start,
                                 T* __restrict__ out,
                                 int B, int H, int S, int layer, float scale) {
  constexpr int D = DPL * 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int64_t head = (int64_t)b * H + h;
  const int64_t row_off = head * D;
  const int64_t plane_off = ((int64_t)layer * B + b) * H + h;  // in rows of S
  const C* kc = k_cache + plane_off * S * D;
  const C* vc = v_cache + plane_off * S * D;
  const float* ksc = QUANT ? k_scale + plane_off * S : nullptr;
  const float* vsc = QUANT ? v_scale + plane_off * S : nullptr;
  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  int st = 0;  // physical row of logical row 0
  if (RING) {
    st = start[b] % S;
    if (st < 0) st += S;
  }

  float qf[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) qf[i] = to_f32(q[row_off + lane * DPL + i]);

  float m, den, acc[DPL];
  if (warp == 0) {  // the self-term seeds warp 0's recurrence
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) s += qf[i] * to_f32(k_new[row_off + lane * DPL + i]);
    m = warp_sum(s) * scale;
    const float vs = QUANT ? vs_new[head] : 1.f;
    if (QUANT) m *= ks_new[head];
    den = 1.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const float v = to_f32(v_new[row_off + lane * DPL + i]);
      acc[i] = QUANT ? v * vs : v;
    }
  } else {
    m = -INFINITY;
    den = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  }

  // Each tile starts below len, so its first row is valid and its max finite.
  for (int t0 = warp * kRows; t0 < len; t0 += kWarps * kRows) {
    float kr[kRows][DPL], vr[kRows][DPL], ks[kRows], vs[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = t0 + r < len;
      int row = t0 + r;
      if (RING) {
        row += st;  // below 2 S for a valid row: one subtraction wraps it
        if (row >= S) row -= S;
      }
      const int64_t o = (int64_t)row * D + lane * DPL;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[r][i] = ok ? to_f32(kc[o + i]) : 0.f;
        vr[r][i] = ok ? to_f32(vc[o + i]) : 0.f;
      }
      ks[r] = QUANT && ok ? ksc[row] : 1.f;
      vs[r] = QUANT && ok ? vsc[row] : 1.f;
    }
    float s[kRows];
    float tmax = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) p += qf[i] * kr[r][i];
      p = warp_sum(p) * scale;
      if (QUANT) p *= ks[r];
      s[r] = t0 + r < len ? p : -INFINITY;
      tmax = fmaxf(tmax, s[r]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    den *= corr;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float e = t0 + r < len ? expf(s[r] - m_new) : 0.f;
      den += e;
      const float ev = QUANT ? e * vs[r] : e;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += ev * vr[r][i];
    }
    m = m_new;
  }

  // Merge the warps' states. Warp 0 always holds a finite max (the self-term).
  __shared__ float sm_m[kWarps];
  __shared__ float sm_den[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_den[warp] = den;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane * DPL + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mx = sm_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float dsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - mx);  // 0 for a warp that saw no rows
      dsum += sm_den[w] * c;
      asum += sm_acc[w][d] * c;
    }
    out[row_off + d] = from_f32<T>(asum / dsum);
  }
}

template <typename T, typename C, bool QUANT, bool RING>
cudaError_t launch(const void* q, const void* k_new, const void* ks_new,
                   const void* v_new, const void* vs_new, const void* k_cache,
                   const void* k_scale, const void* v_cache, const void* v_scale,
                   const void* length, const void* start, void* out, int B,
                   int H, int S, int D, int layer, float scale,
                   cudaStream_t stream) {
  if (RING && S <= 0) return cudaErrorInvalidValue;  // start % S
  const dim3 grid(H, B);
  const dim3 block(kWarps * 32);
#define ZG2_LAUNCH(DPL)                                                          \
  decode_attention_deferred_kernel<T, C, QUANT, RING, DPL>                       \
      <<<grid, block, 0, stream>>>(                                              \
          (const T*)q, (const C*)k_new, (const float*)ks_new, (const C*)v_new,   \
          (const float*)vs_new, (const C*)k_cache, (const float*)k_scale,        \
          (const C*)v_cache, (const float*)v_scale, (const int32_t*)length,      \
          (const int32_t*)start, (T*)out, B, H, S, layer, scale)
  switch (D) {
    case 32: ZG2_LAUNCH(1); break;
    case 64: ZG2_LAUNCH(2); break;
    case 96: ZG2_LAUNCH(3); break;
    case 128: ZG2_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef ZG2_LAUNCH
  return cudaGetLastError();
}

template <bool RING>
int float_cache(const void* q, const void* k_new, const void* v_new,
                const void* k_cache, const void* v_cache, const void* length,
                const void* start, void* out, int B, int H, int S, int D,
                int layer, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, float, false, RING>(q, k_new, nullptr, v_new, nullptr,
                                             k_cache, nullptr, v_cache, nullptr,
                                             length, start, out, B, H, S, D,
                                             layer, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false, RING>(
        q, k_new, nullptr, v_new, nullptr, k_cache, nullptr, v_cache, nullptr,
        length, start, out, B, H, S, D, layer, scale, st);
  return cudaErrorInvalidValue;
}

template <bool RING>
int int8_cache(const void* q, const void* k_new, const void* ks_new,
               const void* v_new, const void* vs_new, const void* k_cache,
               const void* k_scale, const void* v_cache, const void* v_scale,
               const void* length, const void* start, void* out, int B, int H,
               int S, int D, int layer, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, int8_t, true, RING>(q, k_new, ks_new, v_new, vs_new,
                                             k_cache, k_scale, v_cache, v_scale,
                                             length, start, out, B, H, S, D,
                                             layer, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t, true, RING>(
        q, k_new, ks_new, v_new, vs_new, k_cache, k_scale, v_cache, v_scale,
        length, start, out, B, H, S, D, layer, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype code, shared by q, k_new, v_new and the caches: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t.
extern "C" int zg2_decode_attention_deferred(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* length, void* out, int B, int H, int S,
    int D, int layer, float scale, int dtype, void* stream) {
  return float_cache<false>(q, k_new, v_new, k_cache, v_cache, length, nullptr,
                            out, B, H, S, D, layer, scale, dtype, stream);
}

// The ring variant: start (B,) int32, each lane's first physical row.
extern "C" int zg2_decode_attention_deferred_ring(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* length, const void* start, void* out,
    int B, int H, int S, int D, int layer, float scale, int dtype,
    void* stream) {
  return float_cache<true>(q, k_new, v_new, k_cache, v_cache, length, start,
                           out, B, H, S, D, layer, scale, dtype, stream);
}

// INT8 cache: k_new, v_new and the caches int8; ks_new, vs_new (B, H) and
// k_scale, v_scale (L, B, H, S) f32. dtype code of q and out: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t.
extern "C" int zg2_decode_attention_quant_deferred(
    const void* q, const void* k_new, const void* ks_new, const void* v_new,
    const void* vs_new, const void* k_cache, const void* k_scale,
    const void* v_cache, const void* v_scale, const void* length, void* out,
    int B, int H, int S, int D, int layer, float scale, int dtype, void* stream) {
  return int8_cache<false>(q, k_new, ks_new, v_new, vs_new, k_cache, k_scale,
                           v_cache, v_scale, length, nullptr, out, B, H, S, D,
                           layer, scale, dtype, stream);
}

// The INT8 ring variant: start (B,) int32, as in the float one.
extern "C" int zg2_decode_attention_quant_deferred_ring(
    const void* q, const void* k_new, const void* ks_new, const void* v_new,
    const void* vs_new, const void* k_cache, const void* k_scale,
    const void* v_cache, const void* v_scale, const void* length,
    const void* start, void* out, int B, int H, int S, int D, int layer,
    float scale, int dtype, void* stream) {
  return int8_cache<true>(q, k_new, ks_new, v_new, vs_new, k_cache, k_scale,
                          v_cache, v_scale, length, start, out, B, H, S, D,
                          layer, scale, dtype, stream);
}
