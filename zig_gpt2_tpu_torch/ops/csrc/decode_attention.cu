// Single-query decode attention for Hopper (sm_90a), over a float cache or
// an INT8 cache, unpacked or head-pair packed, deferred or appended.
//
// Replaces: zig_gpt2_tpu/ops/attention.py, decode_attention_deferred_fused
// and decode_attention_quant_deferred_fused (the deferred forms), and
// decode_attention_fused and decode_attention_quant_fused (the appended
// forms), bodies _build_kernel (unpacked) and _build_kernel_packed
// (packed), with the prefix mask and with the ring interval (start=). Same
// contract: q (B, H, D); stacked caches (L, B, H, S, D); length (B,) int32;
// layer index; for the ring variants start (B,) int32. Output (B, H, D) in
// q's dtype. The deferred form computes
//
//   softmax over {q.k_new * scale} U {q.k_cache[layer, b, h, row(i)] * scale : i < length[b]}
//   applied to {v_new} U {v_cache[layer, b, h, row(i)]}
//
// and the appended form the same without the self-term (length >= 1 on
// every lane: an empty lane is 0 / 0, as in the TPU kernel), with row(i) =
// i (prefix) or (start[b] + i) mod S (ring: the serving ring cache keeps a
// lane's rows in the interval [start, start + length) mod S).
//
// The running max, denominator and V accumulator are f32. The deferred form
// seeds them with the self-term exactly as the TPU kernel does (m =
// q.k_new * scale, den = 1, acc = v_new); the appended form seeds m = -inf,
// den = 0, acc = 0. Rows outside a lane's length rows are never read: they
// hold stale data and, in the deferred order, the row being appended this
// step.
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
// Head-pair packed (PACKED, head_dim 64 only): a row is two heads, 2D = 128
// elements, and H counts pairs (Hp). Lanes [0, D) of pair p are head 2p and
// lanes [D, 2D) head 2p + 1. An INT8 scale is per pair: one f32 per packed
// row, planes (L, B, Hp, S) and new-row scales (B, Hp); it multiplies both
// halves' scores, and the V scale weights both halves' V. One block per
// (b, pair); each warp reads a whole 128-element pair row, 4 elements per
// lane (a 16 B load at f32, 8 B at bf16, 4 B at int8), lanes 0-15 holding
// head 2p and lanes 16-31 head 2p + 1. Scores reduce over a half-warp and
// each lane keeps only its own head's (m, den, acc) state, so one scale
// load serves both heads of the row. The packed grid has half the blocks
// (13 * 16 = 208 for the 1.5B batcher).
//
// Bound on the H100: device-memory bytes. One call reads 2 * B * H * len * D
// cache elements (plus 2 * B * H * len scales for INT8, half that when
// packed) and does about 4 flops per element read, far below the ~20 flops
// per byte where the f32 (non-tensor) units would become the limit. At
// GPT-2 124M (H=12, D=64), len 1024, f32: 6.3 MB, 1.9 us at 3.35 TB/s. At
// GPT-2 1.5B INT8 (H=25, D=64), len 1023, B=1: 3.3 MB of int8 plus 0.2 MB
// of scales, 1.0 us.
//
// Design against that bound: one block per (b, row of heads) reads its
// layer slice by pointer offset ((layer * B + b) * H + h) * S * W, so no
// slice is copied. Eight warps each take tiles of kRows consecutive rows; a
// tile's K and V rows (and scales) are all loaded before any arithmetic so
// that every warp keeps kRows row loads in flight, and each lane reads
// W / 32 neighbouring elements so a warp's row load is one contiguous
// segment. Each warp keeps its own online softmax state; the eight states
// are merged once through shared memory. Every instantiation is held to two
// resident blocks per SM (at most 128 registers a thread): with more, one
// block fits per SM and a B=16 call's 208 packed or 400 unpacked blocks run
// in more waves over the 132 SMs. Left free, the INT8 ring instantiations
// took up to 192 (packed) and 164 (unpacked) registers and 153 and 142 us,
// against 83 and 79 us under the bound (H100, B=16, R=1025, 1.5B shapes,
// tools/kernel_ab.py).
//
// What it leaves to a later PR: the grid is B * H blocks, so at B = 1 most
// of the 132 SMs idle and one block's latency sets the time; an unpacked
// INT8 row is 64 bytes, 2 bytes per lane. The fix is a split-S
// flash-decode: several blocks per (b, h), each over a range of rows, and
// a combine pass over their (m, den, acc) partials.

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

// Four neighbouring elements (16-byte, 8-byte or 4-byte aligned) as f32,
// with one load instruction.
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = (float)v.x; o[1] = (float)v.y; o[2] = (float)v.z; o[3] = (float)v.w;
}

// Sum over the lanes that hold one head: the whole warp, or (PACKED) the
// half-warp (xor 8, 4, 2, 1 stays inside lanes 0-15 and 16-31).
template <bool PACKED>
__device__ __forceinline__ float head_sum(float x) {
#pragma unroll
  for (int o = PACKED ? 8 : 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Every pointer and size of one call. H counts the cache's rows per lane:
// heads, or head pairs when packed. The self-term pointers are null in the
// appended form, the scale pointers for a float cache, start for the prefix.
struct Args {
  const void* q;
  const void* k_new;
  const float* ks_new;
  const void* v_new;
  const float* vs_new;
  const void* k_cache;
  const float* k_scale;
  const void* v_cache;
  const float* v_scale;
  const int32_t* length;
  const int32_t* start;
  void* out;
  int B, H, S, D, layer;
  float scale;
};

// T: type of q and out. C: type of k_new, v_new and the caches (T, or int8_t
// when QUANT). RING: read the interval from start. PACKED: head-pair rows.
// DEFERRED: seed warp 0 with the self-term. DPL: row elements per lane
// (W / 32, with W = D, or 2D when packed).
template <typename T, typename C, bool QUANT, bool RING, bool PACKED, bool DEFERRED, int DPL>
__global__ void __launch_bounds__(kWarps * 32, 2)
    decode_attention_kernel(const Args a) {
  constexpr int W = DPL * 32;
  static_assert(!PACKED || DPL == 4, "the packed body reads 4 elements per lane");
  const T* q = static_cast<const T*>(a.q);
  const C* k_new = static_cast<const C*>(a.k_new);
  const C* v_new = static_cast<const C*>(a.v_new);
  const int S = a.S;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int64_t head = (int64_t)b * a.H + h;
  const int64_t row_off = head * W;
  const int64_t plane_off = ((int64_t)a.layer * a.B + b) * a.H + h;  // in rows of S
  const C* kc = static_cast<const C*>(a.k_cache) + plane_off * S * W;
  const C* vc = static_cast<const C*>(a.v_cache) + plane_off * S * W;
  const float* ksc = QUANT ? a.k_scale + plane_off * S : nullptr;
  const float* vsc = QUANT ? a.v_scale + plane_off * S : nullptr;
  int len = a.length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  int st = 0;  // physical row of logical row 0
  if (RING) {
    st = a.start[b] % S;
    if (st < 0) st += S;
  }

  float qf[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) qf[i] = to_f32(q[row_off + lane * DPL + i]);

  float m, den, acc[DPL];
  if (DEFERRED && warp == 0) {  // the self-term seeds warp 0's recurrence
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) s += qf[i] * to_f32(k_new[row_off + lane * DPL + i]);
    m = head_sum<PACKED>(s) * a.scale;
    const float vs = QUANT ? a.vs_new[head] : 1.f;
    if (QUANT) m *= a.ks_new[head];
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
      const int64_t o = (int64_t)row * W + lane * DPL;
      if constexpr (PACKED) {
        if (ok) {
          load4(kc + o, kr[r]);
          load4(vc + o, vr[r]);
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) kr[r][i] = vr[r][i] = 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kr[r][i] = ok ? to_f32(kc[o + i]) : 0.f;
          vr[r][i] = ok ? to_f32(vc[o + i]) : 0.f;
        }
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
      p = head_sum<PACKED>(p) * a.scale;
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

  // Merge the warps' states, per head (the row's two heads when packed).
  // In the deferred form warp 0 always holds a finite max (the self-term);
  // in the appended form warp 0 holds the first tile.
  constexpr int kHalves = PACKED ? 2 : 1;
  __shared__ float sm_m[kWarps][kHalves];
  __shared__ float sm_den[kWarps][kHalves];
  __shared__ float sm_acc[kWarps][W];
  if ((lane & (32 / kHalves - 1)) == 0) {
    sm_m[warp][lane * kHalves / 32] = m;
    sm_den[warp][lane * kHalves / 32] = den;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane * DPL + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < W) {
    const int d = threadIdx.x;
    const int half = d * kHalves / W;
    float mx = sm_m[0][half];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][half]);
    float dsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][half] - mx);  // 0 for a warp that saw no rows
      dsum += sm_den[w][half] * c;
      asum += sm_acc[w][d] * c;
    }
    static_cast<T*>(a.out)[row_off + d] = from_f32<T>(asum / dsum);
  }
}

template <typename T, typename C, bool QUANT, bool RING, bool PACKED, bool DEFERRED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (RING && a.S <= 0) return cudaErrorInvalidValue;  // start % S
  const dim3 grid(a.H, a.B);
  const dim3 block(kWarps * 32);
#define ZG2_LAUNCH(DPL)                                                              \
  decode_attention_kernel<T, C, QUANT, RING, PACKED, DEFERRED, DPL><<<grid, block, 0, \
                                                                     stream>>>(a)
  if constexpr (PACKED) {
    if (a.D != 64) return cudaErrorInvalidValue;
    ZG2_LAUNCH(4);
  } else {
    switch (a.D) {
      case 32: ZG2_LAUNCH(1); break;
      case 64: ZG2_LAUNCH(2); break;
      case 96: ZG2_LAUNCH(3); break;
      case 128: ZG2_LAUNCH(4); break;
      default: return cudaErrorInvalidValue;
    }
  }
#undef ZG2_LAUNCH
  return cudaGetLastError();
}

// The packed instantiations exist for DPL = 4 only (head_dim 64).
template <typename T, typename C, bool QUANT, bool RING, bool DEFERRED>
cudaError_t launch_layout(const Args& a, bool packed, cudaStream_t stream) {
  return packed ? launch<T, C, QUANT, RING, true, DEFERRED>(a, stream)
                : launch<T, C, QUANT, RING, false, DEFERRED>(a, stream);
}

// dtype code of q and out: 0 = float32, 1 = bfloat16 (also the cache's
// type for a float cache).
template <bool RING, bool DEFERRED>
int dispatch(const Args& a, bool quant, bool packed, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (quant) {
    if (dtype == 0) return launch_layout<float, int8_t, true, RING, DEFERRED>(a, packed, st);
    if (dtype == 1)
      return launch_layout<__nv_bfloat16, int8_t, true, RING, DEFERRED>(a, packed, st);
  } else {
    if (dtype == 0) return launch_layout<float, float, false, RING, DEFERRED>(a, packed, st);
    if (dtype == 1)
      return launch_layout<__nv_bfloat16, __nv_bfloat16, false, RING, DEFERRED>(a, packed,
                                                                                 st);
  }
  return cudaErrorInvalidValue;
}

Args args(const void* q, const void* k_new, const void* ks_new, const void* v_new,
          const void* vs_new, const void* k_cache, const void* k_scale,
          const void* v_cache, const void* v_scale, const void* length,
          const void* start, void* out, int B, int H, int S, int D, int layer,
          float scale) {
  return Args{q, k_new, (const float*)ks_new, v_new, (const float*)vs_new, k_cache,
              (const float*)k_scale, v_cache, (const float*)v_scale,
              (const int32_t*)length, (const int32_t*)start, out, B, H, S, D, layer,
              scale};
}

// --- entry points. One per form and cache type; each takes start (null for
// the prefix rows, else (B,) int32, each lane's first physical row) and
// packed (0 or 1: q, the current rows and the caches in pairs, H = Hp,
// D = 64). dtype code of q and out: 0 = float32, 1 = bfloat16 (also the
// type of a float cache and its current rows). For an INT8 cache k_new,
// v_new and the caches are int8, with f32 scales ks_new, vs_new (B, H) and
// planes k_scale, v_scale (L, B, H, S) (per pair when packed). Each
// returns a cudaError_t. -------------------------------------------------

template <bool DEFERRED>
int dispatch_start(const Args& a, bool quant, int packed, int dtype, void* stream) {
  return a.start ? dispatch<true, DEFERRED>(a, quant, packed != 0, dtype, stream)
                 : dispatch<false, DEFERRED>(a, quant, packed != 0, dtype, stream);
}

}  // namespace

extern "C" int zg2_decode_attention_deferred(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* length, const void* start, void* out, int B,
    int H, int S, int D, int layer, float scale, int dtype, int packed, void* stream) {
  return dispatch_start<true>(args(q, k_new, nullptr, v_new, nullptr, k_cache, nullptr,
                                   v_cache, nullptr, length, start, out, B, H, S, D,
                                   layer, scale),
                              false, packed, dtype, stream);
}

extern "C" int zg2_decode_attention_quant_deferred(
    const void* q, const void* k_new, const void* ks_new, const void* v_new,
    const void* vs_new, const void* k_cache, const void* k_scale,
    const void* v_cache, const void* v_scale, const void* length,
    const void* start, void* out, int B, int H, int S, int D, int layer,
    float scale, int dtype, int packed, void* stream) {
  return dispatch_start<true>(args(q, k_new, ks_new, v_new, vs_new, k_cache, k_scale,
                                   v_cache, v_scale, length, start, out, B, H, S, D,
                                   layer, scale),
                              true, packed, dtype, stream);
}

// The appended form (no self-term).
extern "C" int zg2_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* length,
                                    const void* start, void* out, int B, int H, int S,
                                    int D, int layer, float scale, int dtype,
                                    int packed, void* stream) {
  return dispatch_start<false>(args(q, nullptr, nullptr, nullptr, nullptr, k_cache,
                                    nullptr, v_cache, nullptr, length, start, out, B, H,
                                    S, D, layer, scale),
                               false, packed, dtype, stream);
}

extern "C" int zg2_decode_attention_quant(const void* q, const void* k_cache,
                                          const void* k_scale, const void* v_cache,
                                          const void* v_scale, const void* length,
                                          const void* start, void* out, int B, int H,
                                          int S, int D, int layer, float scale,
                                          int dtype, int packed, void* stream) {
  return dispatch_start<false>(args(q, nullptr, nullptr, nullptr, nullptr, k_cache,
                                    k_scale, v_cache, v_scale, length, start, out, B, H,
                                    S, D, layer, scale),
                               true, packed, dtype, stream);
}
