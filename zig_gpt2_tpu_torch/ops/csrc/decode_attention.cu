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
// q's dtype; a float cache may be float32 or bfloat16 whatever q's dtype,
// as in the TPU kernel (each operand is read in its own type, the sums are
// f32). The deferred form computes
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
// Ring (RING): the blocks walk the logical rows i in [0, len) with the same
// splits, tiles and warp rows as the prefix kernel, and copy physical row
// (start + i) mod S, computed per row since a tile may straddle the wrap.
// So a ring lane reads exactly the bytes a prefix lane of the same length
// reads (no mask scan over S), and a ring cache that holds a linear cache's
// rows rotated by start gives a bit-identical result.
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
// halves' scores, and the V scale weights both halves' V. Each warp reads
// a whole 128-element pair row, 4 elements per lane (one shared-memory load
// of 16 B at f32, 8 B at bf16, 4 B at int8), lanes 0-15 holding
// head 2p and lanes 16-31 head 2p + 1. Scores reduce over a half-warp and
// each lane keeps only its own head's (m, den, acc) state, so one scale
// load serves both heads of the row. The packed grid has half the blocks
// of each split (13 * 16 = 208 for the 1.5B batcher).
//
// Bound on the H100: device-memory bytes, and at B = 1 the SMs in use. One
// call reads 2 * B * H * len * D cache elements (plus 2 * B * H * len
// scales for INT8, half that when packed) and does about 4 flops per
// element read, far below the ~20 flops per byte where the f32 (non-tensor)
// units would become the limit. At GPT-2 124M (H=12, D=64), len 1024, f32:
// 6.3 MB, 1.9 us at 3.35 TB/s. At GPT-2 1.5B INT8 (H=25, D=64), len 1023,
// B=1: 3.3 MB of int8 plus 0.2 MB of scales, 1.0 us. With one block per
// (b, head) a B=1 call runs on 25 (or 13 packed) of the 132 SMs, and each
// block walks all rows in turn with a few rows in flight per warp.
//
// Design against that bound: split-S flash-decode in one launch.
// - The grid is (splits, H, B). Block s walks the logical rows
//   [s * chunk, min((s + 1) * chunk, len)); the host picks splits and
//   chunk from (B, H, S) alone (ops/attention.py attention_splits), never
//   from length, which lives on the card. The chunk depends on B and H
//   only (enough blocks for every SM over a GPT-2 cache), so a lane's
//   result does not depend on the cache's S: splits past its rows add
//   exact zeros. At 1.5B B=1 that is 8 splits of 136 rows (200 blocks),
//   packed 16 of 68 (208), at 124M 16 of 68. At B=16 the 400 (208 packed)
//   blocks already fill the card and take one split.
// - Rows reach shared memory by cp.async, 16 bytes a thread, in a ring of
//   kStages = 2 tiles of TR rows (TR * row bytes = 8 KB for K and for V),
//   with INT8 scales by 4-byte copies; tile t + 1 is in flight while tile
//   t is summed. (On the H100 this beat 4 tiles of 4 KB and 8 tiles of 4 KB
//   in dynamic shared memory at B=16: fewer block barriers per row.) A row's bytes are contiguous, so a warp's copy covers 8 INT8
//   rows of 64 bytes at once. Rows past a split's end are never read: their
//   copies zero-fill (stale rows may hold NaN). The ring maps each row to
//   its physical row (start + i) mod S in the copy, so the arithmetic sees
//   the prefix kernel's logical order and a ring cache rotated by start
//   gives a bit-identical result.
// - Each of the 8 warps sums TR / 8 rows of every tile. A lane reads 16
//   bytes of a row from shared memory (an INT8 row of 64 bytes is 4 lanes,
//   so a warp reads 8 rows at once; an f32 row 16 lanes), the head's lanes
//   sum the dot product by shuffles, and each lane keeps the online softmax
//   state of its row slot; the slots merge by a fixed shuffle tree, the
//   warps through shared memory. Only split 0's warp 0 is seeded with the
//   self-term in the deferred form. (head_dim 96, whose rows are no power
//   of two of 16 bytes, takes 32 lanes per row.)
// - The combine is in the same launch: each block writes its (m, den, acc)
//   partial to a scratch tensor, takes a ticket from a self-resetting
//   counter per (b, head), and the last block to arrive merges the
//   partials in split order (the order, not the arrival, fixes every
//   rounding, so the result is deterministic). A thread-block cluster
//   merging through distributed shared memory was the other choice; it
//   caps the splits at 8 (16 non-portable) and needs the whole cluster
//   co-scheduled on one GPC, while a ticket costs one atomic per block and
//   a read of splits * (W + 4) floats from L2 by one block.
// - No tensor cores, on purpose: there is one query row per head (M = 1),
//   and the bound is bytes and the SMs in use, not products.
// - Every instantiation is held to two resident blocks per SM (at most 128
//   registers a thread; left free the INT8 ring instantiations took up to
//   192 and ran 1.8x slower at B=16, PR 4's tools/kernel_ab.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;        // tiles in flight per block
constexpr int kTileBytes = 8192;  // bytes of K rows (and of V rows) per tile

// Rows per tile for a row of RB bytes: the largest power of two, at least
// one row per warp, whose K rows fit kTileBytes.
template <int RB>
__host__ __device__ constexpr int tile_rows() {
  int t = kWarps;
  while (2 * t * RB <= kTileBytes) t *= 2;
  return t;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A lane's N neighbouring elements of a row in shared memory, as f32: one
// 16-byte load when they are 16 bytes, else element by element.
template <int N, typename C>
__device__ __forceinline__ void load_elems(const C* p, float* o) {
  if constexpr (N * sizeof(C) == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(C) == 4) {
        o[j] = __uint_as_float(w[j]);
      } else if constexpr (sizeof(C) == 2) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        o[2 * j] = f.x;
        o[2 * j + 1] = f.y;
      } else {  // int8 b as (2^23 + (b ^ 0x80)) - (2^23 + 128): no conversion
        const uint32_t u = w[j] ^ 0x80808080u;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          o[4 * j + b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.0f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f32(p[i]);
  }
}

// Sum over the L lanes that hold one head of a row: aligned groups of L
// neighbouring lanes (xor L/2, ..., 1 stays inside the group).
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Every pointer and size of one call. H counts the cache's rows per lane:
// heads, or head pairs when packed. The self-term pointers are null in the
// appended form, the scale pointers for a float cache, start for the prefix.
// partial: (B, H, splits, W + 4) f32 scratch and tickets: (B * H) int32
// counters at 0, both unused when splits == 1.
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
  float* partial;
  int* tickets;
  int B, H, S, D, layer, splits, chunk;
  float scale;
};

// T: type of q and out. C: type of the caches (float32 or bfloat16, or
// int8_t when QUANT). k_new and v_new are of type T, or int8_t when QUANT. RING: read the interval from start. PACKED: head-pair rows.
// DEFERRED: seed split 0's warp 0 with the self-term. DPL: W / 32, with the
// row width W = D, or 2D when packed.
template <typename T, typename C, bool QUANT, bool RING, bool PACKED, bool DEFERRED, int DPL>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_kernel(const Args a) {
  constexpr int W = DPL * 32;
  constexpr int RB = W * (int)sizeof(C);  // bytes per row
  constexpr int EPC = 16 / (int)sizeof(C);  // elements per 16-byte copy
  constexpr int CPR = RB / 16;              // copies per row
  constexpr int TR = tile_rows<RB>();
  constexpr int RPW = TR / kWarps;          // rows per warp per tile
  constexpr int kHalves = PACKED ? 2 : 1;
  constexpr int kScaleRows = QUANT ? TR : 1;
  static_assert(!PACKED || DPL == 4, "packed rows are two heads of 64");
  static_assert(RB % 16 == 0, "rows are copied 16 bytes at a time");

  __shared__ __align__(16) C sk[kStages][TR * W];
  __shared__ __align__(16) C sv[kStages][TR * W];
  __shared__ float sks[kStages][kScaleRows];
  __shared__ float svs[kStages][kScaleRows];
  __shared__ float sm_m[kWarps][kHalves];
  __shared__ float sm_den[kWarps][kHalves];
  __shared__ float sm_acc[kWarps][W];

  const T* q = static_cast<const T*>(a.q);
  using N = typename std::conditional<QUANT, int8_t, T>::type;  // the current row
  const N* k_new = static_cast<const N*>(a.k_new);
  const N* v_new = static_cast<const N*>(a.v_new);
  const int S = a.S;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
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
  const int lo = split * a.chunk;
  const int hi = min(lo + a.chunk, len);
  const int ntiles = hi > lo ? (hi - lo + TR - 1) / TR : 0;

  // Tile t of this split into stage t % kStages (an empty group past the
  // last tile keeps the wait counts uniform).
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int stage = t % kStages;
      const int base = lo + t * TR;
      for (int c = threadIdx.x; c < TR * CPR; c += kThreads) {
        const int r = c / CPR, part = c - r * CPR;
        const int i = base + r;
        const bool ok = i < hi;
        int row = 0;
        if (ok) {
          row = i;
          if (RING) {
            row += st;  // below 2 S: one subtraction wraps it
            if (row >= S) row -= S;
          }
        }
        const int64_t o = (int64_t)row * W + part * EPC;
        zg2::cp_async16(&sk[stage][r * W + part * EPC], kc + o, ok);
        zg2::cp_async16(&sv[stage][r * W + part * EPC], vc + o, ok);
      }
      if constexpr (QUANT) {
        for (int r = threadIdx.x; r < TR; r += kThreads) {
          const int i = base + r;
          const bool ok = i < hi;
          int row = 0;
          if (ok) {
            row = i;
            if (RING) {
              row += st;
              if (row >= S) row -= S;
            }
          }
          zg2::cp_async4(&sks[stage][r], ksc + row, ok);
          zg2::cp_async4(&svs[stage][r], vsc + row, ok);
        }
      }
    }
    zg2::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // Lane layout: LPR lanes read one row, EPL elements (16 bytes) each, so
  // a warp step covers RPI rows (8 INT8 rows of 64 bytes); a head's dot
  // product reduces over its HL lanes. A row width that is no power of two
  // (head_dim 96) takes 32 lanes per row instead.
  constexpr bool kVec = (RB & (RB - 1)) == 0 && RB <= 512;
  constexpr int LPR = kVec ? RB / 16 : 32;
  constexpr int EPL = W / LPR;
  constexpr int RPI = 32 / LPR;
  constexpr int HL = LPR / kHalves;
  constexpr int STEPS = RPW / RPI;
  static_assert(STEPS >= 1 && RPW % RPI == 0, "a warp's tile rows are whole steps");
  const int gi = lane / LPR;        // the lane's row within a step
  const int col = (lane % LPR) * EPL;  // its first element of the row
  const int hh = col * kHalves / W;    // its head within the row

  float qf[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) qf[i] = to_f32(q[row_off + col + i]);

  // Each lane keeps the online softmax state of its row of every step.
  float m = -INFINITY, den = 0.f, acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;
  if (DEFERRED && split == 0 && warp == 0) {  // the self-term seeds one recurrence
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) s += qf[i] * to_f32(k_new[row_off + col + i]);
    s = group_sum<HL>(s) * a.scale;
    if (QUANT) s *= a.ks_new[head];
    if (gi == 0) {
      m = s;
      den = 1.f;
      const float vs = QUANT ? a.vs_new[head] : 1.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const float v = to_f32(v_new[row_off + col + i]);
        acc[i] = QUANT ? v * vs : v;
      }
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    issue(t + kStages - 1);
    zg2::cp_async_wait<kStages - 1>();  // this thread's copies of tile t landed
    __syncthreads();                     // and every thread's
    const int stage = t % kStages;
    const int first = lo + t * TR;  // logical row of the tile's first row
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int r = warp * RPW + j * RPI + gi;
      float kf[EPL];
      load_elems<EPL>(&sk[stage][r * W + col], kf);
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) p += qf[i] * kf[i];
      p = group_sum<HL>(p) * a.scale;
      if constexpr (QUANT) p *= sks[stage][r];
      if (first + r < hi) {
        const float m_new = fmaxf(m, p);
        const float corr = expf(m - m_new);  // 0 while m = -inf
        const float e = expf(p - m_new);
        den = den * corr + e;
        float ev = e;
        if constexpr (QUANT) ev *= svs[stage][r];
        float vf[EPL];
        load_elems<EPL>(&sv[stage][r * W + col], vf);
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[i] = acc[i] * corr + ev * vf[i];
        m = m_new;
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }
  zg2::cp_async_wait<0>();

  // Merge the rows of a step within the warp (a fixed xor tree: partners
  // compute the same sums), then the warps' states through shared memory,
  // per head (the row's two heads when packed). A state that saw no row
  // holds m = -inf and adds nothing.
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float d_o = __shfl_xor_sync(0xffffffffu, den, o);
    const float mx = fmaxf(m, m_o);
    const float c = m == -INFINITY ? 0.f : expf(m - mx);
    const float c_o = m_o == -INFINITY ? 0.f : expf(m_o - mx);
    den = den * c + d_o * c_o;
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      acc[i] = acc[i] * c + __shfl_xor_sync(0xffffffffu, acc[i], o) * c_o;
    m = mx;
  }
  if (gi == 0) {
    if (col % (W / kHalves) == 0) {
      sm_m[warp][hh] = m;
      sm_den[warp][hh] = den;
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][col + i] = acc[i];
  }
  __syncthreads();
  const int d = threadIdx.x;
  const int half = d * kHalves / W;
  float mx = -INFINITY, dsum = 0.f, asum = 0.f;
  if (d < W) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][half]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = sm_m[w][half] == -INFINITY ? 0.f : expf(sm_m[w][half] - mx);
      dsum += sm_den[w][half] * c;
      asum += sm_acc[w][d] * c;
    }
  }
  T* out = static_cast<T*>(a.out);
  if (gridDim.x == 1) {
    if (d < W) out[row_off + d] = from_f32<T>(asum / dsum);
    return;
  }

  // Split combine: this block's partial, then the last block of the
  // (b, head) merges all of them in split order.
  float* part = a.partial + head * gridDim.x * (W + 4);
  if (d < W) {
    part[split * (W + 4) + d] = asum;
    if ((d & (W / kHalves - 1)) == 0) {
      part[split * (W + 4) + W + half] = mx;
      part[split * (W + 4) + W + 2 + half] = dsum;
    }
  }
  if (!zg2::last_to_arrive(a.tickets + head, gridDim.x)) return;
  // The partials, 16 at a time, into shared memory (the K stages are free)
  // so that their L2 round trips overlap, each batch merged in split order
  // into the running state. A split past the lane's rows adds exact zeros,
  // so the result does not depend on how many splits the cache's S made.
  static_assert(sizeof(sk) >= 16 * (W + 4) * sizeof(float), "room for 16 partials");
  float* ps = reinterpret_cast<float*>(&sk[0][0]);
  float gm = -INFINITY, gd = 0.f, ga = 0.f;
  for (int s0 = 0; s0 < (int)gridDim.x; s0 += 16) {
    const int ns = min(16, (int)gridDim.x - s0);
    for (int i = threadIdx.x; i < ns * (W + 4); i += kThreads)
      ps[i] = __ldcg(part + s0 * (W + 4) + i);
    __syncthreads();
    if (d < W) {
      float bm = gm;
      for (int s = 0; s < ns; ++s) bm = fmaxf(bm, ps[s * (W + 4) + W + half]);
      const float co = gm == -INFINITY ? 0.f : expf(gm - bm);
      gd *= co;
      ga *= co;
      for (int s = 0; s < ns; ++s) {
        const float* pt = ps + s * (W + 4);
        const float ms = pt[W + half];
        const float c = ms == -INFINITY ? 0.f : expf(ms - bm);
        gd += pt[W + 2 + half] * c;
        ga += pt[d] * c;
      }
      gm = bm;
    }
    __syncthreads();
  }
  if (d < W) out[row_off + d] = from_f32<T>(ga / gd);
}

template <typename T, typename C, bool QUANT, bool RING, bool PACKED, bool DEFERRED, int DPL>
cudaError_t launch_body(const Args& a, dim3 grid, cudaStream_t stream) {
  decode_attention_kernel<T, C, QUANT, RING, PACKED, DEFERRED, DPL>
      <<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename C, bool QUANT, bool RING, bool PACKED, bool DEFERRED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (RING && a.S <= 0) return cudaErrorInvalidValue;  // start % S
  // The splits cover [0, S) and none starts past it; a split launch needs
  // its scratch.
  if (a.splits < 1 || a.chunk < 1 || (int64_t)a.chunk * a.splits < a.S ||
      (int64_t)a.chunk * (a.splits - 1) >= (a.S > 0 ? a.S : 1) ||
      (a.splits > 1 && (!a.partial || !a.tickets)))
    return cudaErrorInvalidValue;
  const dim3 grid(a.splits, a.H, a.B);
  if constexpr (PACKED) {
    if (a.D != 64) return cudaErrorInvalidValue;
    return launch_body<T, C, QUANT, RING, PACKED, DEFERRED, 4>(a, grid, stream);
  } else {
    switch (a.D) {
      case 32: return launch_body<T, C, QUANT, RING, PACKED, DEFERRED, 1>(a, grid, stream);
      case 64: return launch_body<T, C, QUANT, RING, PACKED, DEFERRED, 2>(a, grid, stream);
      case 96: return launch_body<T, C, QUANT, RING, PACKED, DEFERRED, 3>(a, grid, stream);
      case 128: return launch_body<T, C, QUANT, RING, PACKED, DEFERRED, 4>(a, grid, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

// The packed instantiations exist for DPL = 4 only (head_dim 64).
template <typename T, typename C, bool QUANT, bool RING, bool DEFERRED>
cudaError_t launch_layout(const Args& a, bool packed, cudaStream_t stream) {
  return packed ? launch<T, C, QUANT, RING, true, DEFERRED>(a, stream)
                : launch<T, C, QUANT, RING, false, DEFERRED>(a, stream);
}

// dtype code: q's (and out's) type, 0 = float32, 1 = bfloat16, plus for a
// float cache twice the cache's type in the same code (0 to 3).
template <bool RING, bool DEFERRED>
int dispatch(const Args& a, bool quant, bool packed, int dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t st = (cudaStream_t)stream;
  if (quant) {
    if (dtype == 0) return launch_layout<float, int8_t, true, RING, DEFERRED>(a, packed, st);
    if (dtype == 1) return launch_layout<bf16, int8_t, true, RING, DEFERRED>(a, packed, st);
  } else {
    switch (dtype) {
      case 0: return launch_layout<float, float, false, RING, DEFERRED>(a, packed, st);
      case 1: return launch_layout<bf16, float, false, RING, DEFERRED>(a, packed, st);
      case 2: return launch_layout<float, bf16, false, RING, DEFERRED>(a, packed, st);
      case 3: return launch_layout<bf16, bf16, false, RING, DEFERRED>(a, packed, st);
    }
  }
  return cudaErrorInvalidValue;
}

Args args(const void* q, const void* k_new, const void* ks_new, const void* v_new,
          const void* vs_new, const void* k_cache, const void* k_scale,
          const void* v_cache, const void* v_scale, const void* length,
          const void* start, void* out, void* partial, void* tickets, int B, int H,
          int S, int D, int layer, int splits, int chunk, float scale) {
  return Args{q, k_new, (const float*)ks_new, v_new, (const float*)vs_new, k_cache,
              (const float*)k_scale, v_cache, (const float*)v_scale,
              (const int32_t*)length, (const int32_t*)start, out, (float*)partial,
              (int*)tickets, B, H, S, D, layer, splits, chunk, scale};
}

// --- entry points. One per form and cache type; each takes start (null for
// the prefix rows, else (B,) int32, each lane's first physical row) and
// packed (0 or 1: q, the current rows and the caches in pairs, H = Hp,
// D = 64). dtype code of q, out and the current rows: 0 = float32,
// 1 = bfloat16, plus for a float cache 2 x its type (so 0 to 3: f32 q
// over a bf16 cache is 2). For an INT8 cache k_new, v_new and the caches
// are int8, with f32 scales ks_new, vs_new (B, H) and
// planes k_scale, v_scale (L, B, H, S) (per pair when packed). splits and
// chunk: the split geometry (splits * chunk >= S); partial (B, H, splits,
// W + 4) f32 and tickets (B * H) int32 at 0, unused (may be null) when
// splits == 1. Each returns a cudaError_t. -----------------------------

template <bool DEFERRED>
int dispatch_start(const Args& a, bool quant, int packed, int dtype, void* stream) {
  return a.start ? dispatch<true, DEFERRED>(a, quant, packed != 0, dtype, stream)
                 : dispatch<false, DEFERRED>(a, quant, packed != 0, dtype, stream);
}

}  // namespace

extern "C" int zg2_decode_attention_deferred(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* length, const void* start, void* out,
    void* partial, void* tickets, int B, int H, int S, int D, int layer, int splits,
    int chunk, float scale, int dtype, int packed, void* stream) {
  return dispatch_start<true>(args(q, k_new, nullptr, v_new, nullptr, k_cache, nullptr,
                                   v_cache, nullptr, length, start, out, partial,
                                   tickets, B, H, S, D, layer, splits, chunk, scale),
                              false, packed, dtype, stream);
}

extern "C" int zg2_decode_attention_quant_deferred(
    const void* q, const void* k_new, const void* ks_new, const void* v_new,
    const void* vs_new, const void* k_cache, const void* k_scale,
    const void* v_cache, const void* v_scale, const void* length,
    const void* start, void* out, void* partial, void* tickets, int B, int H, int S,
    int D, int layer, int splits, int chunk, float scale, int dtype, int packed,
    void* stream) {
  return dispatch_start<true>(args(q, k_new, ks_new, v_new, vs_new, k_cache, k_scale,
                                   v_cache, v_scale, length, start, out, partial,
                                   tickets, B, H, S, D, layer, splits, chunk, scale),
                              true, packed, dtype, stream);
}

// The appended form (no self-term).
extern "C" int zg2_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* length,
                                    const void* start, void* out, void* partial,
                                    void* tickets, int B, int H, int S, int D, int layer,
                                    int splits, int chunk, float scale, int dtype,
                                    int packed, void* stream) {
  return dispatch_start<false>(args(q, nullptr, nullptr, nullptr, nullptr, k_cache,
                                    nullptr, v_cache, nullptr, length, start, out, partial,
                                    tickets, B, H, S, D, layer, splits, chunk, scale),
                               false, packed, dtype, stream);
}

extern "C" int zg2_decode_attention_quant(const void* q, const void* k_cache,
                                          const void* k_scale, const void* v_cache,
                                          const void* v_scale, const void* length,
                                          const void* start, void* out, void* partial,
                                          void* tickets, int B, int H, int S, int D,
                                          int layer, int splits, int chunk, float scale,
                                          int dtype, int packed, void* stream) {
  return dispatch_start<false>(args(q, nullptr, nullptr, nullptr, nullptr, k_cache,
                                    k_scale, v_cache, v_scale, length, start, out, partial,
                                    tickets, B, H, S, D, layer, splits, chunk, scale),
                               true, packed, dtype, stream);
}
