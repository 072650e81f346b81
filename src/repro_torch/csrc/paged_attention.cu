// paged_attention: decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py::_call_kernel, the Pallas
// TPU kernel bodies _kernel (compute-dtype pool) and _kernel_int8 (int8 pool
// with per-token scales).  Per decode slot b: gather the slot's blocks
// through its table, dequantize int8 rows by their per-token scale (in the
// compute dtype, as bf16(k) * bf16(scale) in the reference), expand GQA
// heads, softmax over key positions kpos <= lens[b], cast P to the compute
// dtype, then P.V.
//
// What bounds it on this card: the bytes of the slot's K/V rows.  Each
// cached row is used by `groups` query heads of one token, so the work is a
// few operations per byte: bound by HBM bandwidth (3.35 TB/s).
//
// What the design does about that: the TPU kernel held the whole pool in
// VMEM, which only fits toy pools; here the pool stays in HBM.  One CTA per
// (slot, KV head) serves that head's `groups` query heads, so each K/V row
// is read once from HBM, as coalesced hd-element rows.  The CTA reads only
// the len + 1 positions the mask admits: blocks past the sequence are never
// touched.  Three passes, so that the rounding follows the reference's
// (normalised P rounded to the compute dtype before P.V) rather than an
// online softmax's:
//   1. scores: one warp per key position, q.k in f32 times the scale,
//      written to an f32 scratch row [B, H, M*bs] that the wrapper
//      allocates (a few bytes per position, next to hd-wide K/V rows);
//   2. softmax per query head: block max, block sum of exp(s - max), then
//      P = dt(exp(s - max) / sum) written back over the scores.  Masked
//      positions carry exactly zero weight in the reference
//      (exp(-1e30 - max) underflows), so they are simply not visited;
//   3. P.V: each thread owns one output column for a slice of the
//      positions, with f32 accumulators for up to GMAX query heads; the
//      slices are summed through shared memory and rounded once to dt.
// lens must be >= 0.  Inactive slots (all-null tables, len 0) read block 0
// and produce finite values that the caller discards.
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;  // query heads per pass over V

struct Params {
  const void* q;          // [B, H, hd] compute dtype
  const void* kp;         // [N, bs, Hkv, hd] pool payload
  const void* vp;
  const float* ks;        // [N, bs] per-token scales (int8 pool) or null
  const float* vs;
  const int* tables;      // [B, M]
  const int* lens;        // [B]
  float* probs;           // [B, H, M*bs] f32 scratch: scores, then P
  void* out;              // [B, H, hd] compute dtype
  int H, Hkv, hd, bs, M;
  float scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
template <typename T> __device__ __forceinline__ float round_dt(float v);
template <> __device__ __forceinline__ float round_dt<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_dt<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduce over the block; every thread gets the result.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// A pool element as the reference's compute-dtype value: dt(x), and for an
// int8 pool dt(dt(x) * dt(scale)).
template <typename T, bool INT8>
__device__ __forceinline__ float kv_value(float x, float sc) {
  const float v = round_dt<T>(x);
  return INT8 ? round_dt<T>(v * sc) : v;
}

template <typename T, typename KV>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(Params p) {
  constexpr bool INT8 = sizeof(KV) == 1;
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int G = p.H / p.Hkv, hd = p.hd, bs = p.bs, T_all = p.M * bs;
  const int TS = hd >= THREADS ? 1 : THREADS / hd;  // position slices (P.V)
  float* qs = smem;                 // [G, hd]
  float* red = qs + G * hd;         // [WARPS]
  float* pv = red + WARPS;          // [TS, GMAX, hd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(p.q);
  const KV* kp = static_cast<const KV*>(p.kp);
  const KV* vp = static_cast<const KV*>(p.vp);
  const int* table = p.tables + (size_t)b * p.M;
  float* probs = p.probs + ((size_t)b * p.H + (size_t)g * G) * T_all;
  for (int i = tid; i < G * hd; i += THREADS)
    qs[i] = to_f(q[((size_t)b * p.H + g * G) * hd + i]);
  const int len = p.lens[b];
  const int nvalid = len + 1 < T_all ? len + 1 : T_all;  // kpos <= len
  __syncthreads();

  // 1. scores, one warp per key position
  for (int t = warp; t < nvalid; t += WARPS) {
    const size_t tok = (size_t)table[t / bs] * bs + t % bs;
    const KV* krow = kp + (tok * p.Hkv + g) * hd;
    const float sc = INT8 ? round_dt<T>(p.ks[tok]) : 0.0f;
    for (int gi = 0; gi < G; ++gi) {
      float dot = 0.0f;
      for (int d = lane; d < hd; d += 32)
        dot = fmaf(qs[gi * hd + d], kv_value<T, INT8>(to_f(krow[d]), sc), dot);
      dot = warp_sum(dot);
      if (lane == 0) probs[(size_t)gi * T_all + t] = dot * p.scale;
    }
  }
  __syncthreads();

  // 2. softmax over the admitted positions, P rounded to the compute dtype
  for (int gi = 0; gi < G; ++gi) {
    float* row = probs + (size_t)gi * T_all;
    float m = -INFINITY;
    for (int t = tid; t < nvalid; t += THREADS) m = fmaxf(m, row[t]);
    m = block_reduce<true>(m, red);
    float l = 0.0f;
    for (int t = tid; t < nvalid; t += THREADS) l += expf(row[t] - m);
    l = block_reduce<false>(l, red);
    for (int t = tid; t < nvalid; t += THREADS)
      row[t] = round_dt<T>(expf(row[t] - m) / l);
  }
  __syncthreads();

  // 3. P.V: thread (slice ts, column d); slices summed in shared memory
  T* out = static_cast<T*>(p.out);
  const int ts = tid / hd;
  for (int g0 = 0; g0 < G; g0 += GMAX) {
    const int gc = G - g0 < GMAX ? G - g0 : GMAX;
    if (ts < TS) {
      for (int d = tid % hd; d < hd; d += THREADS) {
        float acc[GMAX];
#pragma unroll
        for (int j = 0; j < GMAX; ++j) acc[j] = 0.0f;
        for (int t = ts; t < nvalid; t += TS) {
          const size_t tok = (size_t)table[t / bs] * bs + t % bs;
          const float sc = INT8 ? round_dt<T>(p.vs[tok]) : 0.0f;
          const float v = kv_value<T, INT8>(
              to_f(vp[(tok * p.Hkv + g) * hd + d]), sc);
#pragma unroll
          for (int j = 0; j < GMAX; ++j)
            if (j < gc)
              acc[j] = fmaf(probs[(size_t)(g0 + j) * T_all + t], v, acc[j]);
        }
        for (int j = 0; j < gc; ++j) pv[(ts * GMAX + j) * hd + d] = acc[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < gc * hd; i += THREADS) {
      const int j = i / hd, d = i % hd;
      float s = 0.0f;
      for (int k = 0; k < TS; ++k) s += pv[(k * GMAX + j) * hd + d];
      out[((size_t)b * p.H + g * G + g0 + j) * hd + d] = from_f<T>(s);
    }
    __syncthreads();
  }
}

template <typename T, typename KV>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const int TS = p.hd >= THREADS ? 1 : THREADS / p.hd;
  const size_t smem = sizeof(float) *
      ((size_t)G * p.hd + WARPS + (size_t)TS * GMAX * p.hd);
  auto kern = paged_attention_kernel<T, KV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, p.Hkv), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// kv_kind: 0 = f32 pool, 1 = bf16 pool, 2 = int8 pool with per-token scales
extern "C" int paged_attention_launch(
    const void* q, const void* kp, const void* vp, const float* ks,
    const float* vs, const int* tables, const int* lens, float* probs,
    void* out, int B, int H, int Hkv, int hd, int bs, int M, float scale,
    int q_bf16, int kv_kind, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || bs <= 0 || M <= 0 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.kp = kp; p.vp = vp;
  p.ks = ks; p.vs = vs;
  p.tables = tables; p.lens = lens; p.probs = probs; p.out = out;
  p.H = H; p.Hkv = Hkv; p.hd = hd; p.bs = bs; p.M = M; p.scale = scale;
  typedef __nv_bfloat16 bf16;
  if (q_bf16) {
    if (kv_kind == 0) return launch<bf16, float>(p, B, stream);
    if (kv_kind == 1) return launch<bf16, bf16>(p, B, stream);
    return launch<bf16, int8_t>(p, B, stream);
  }
  if (kv_kind == 0) return launch<float, float>(p, B, stream);
  if (kv_kind == 1) return launch<float, bf16>(p, B, stream);
  return launch<float, int8_t>(p, B, stream);
}
