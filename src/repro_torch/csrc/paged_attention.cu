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
// few operations per byte: bound by HBM bandwidth (3.35 TB/s).  At decode
// sizes (a few MB) the real limit is latency: enough positions must be in
// flight on every SM, and each load must bring many bytes.
//
// What the design does about that:
// * Split over positions.  The grid is (slot, KV head, chunk of CHUNK = 64
//   positions), so a slot of 4096 positions runs on 64 CTAs instead of one.
//   A CTA whose chunk starts past lens[b] returns at once; a CTA loads its
//   chunk's token indices (through the block table) and int8 scales into
//   shared memory once.
// * Vector row reads.  A K row (hd contiguous elements) is read by a
//   sub-group of L lanes (hd/8 rounded up to a power of two, 8 to 32, fixed
//   at compile time), EL = 8 elements a lane: one 16-byte load for bf16,
//   two for f32, one 8-byte load for int8 (so that the q columns a lane
//   multiplies stay in registers for 8 query heads).  A warp scores 4
//   positions at once at hd 64, 2 at hd 128.  The 8 head sums are reduced
//   inside the sub-group only, by a butterfly reduce-scatter of
//   __shfl_xor_sync steps (8 shuffles at L = 16 where a sum a head would
//   take 32).  hd must be a multiple of 8 (every configuration's is: 64,
//   120, 128, 256; hd 120 in int8 is 15 loads of 8 bytes) and the pool
//   bases aligned to a vector, else the launch is refused.  In P.V each
//   thread owns the same 8 consecutive columns of a position slice, for up
//   to GMAX = 8 query heads of the group in registers, so each V row is
//   read once for the whole GQA group.
// * The reference's rounding of P: P = dt(exp(s - m) / l) with the row's
//   global m and l, before P.V (an online softmax that never rounds P is a
//   different result in bf16).  So two launches:
//   (a) scores: each CTA writes its chunk's scores (f32, times the scale)
//       to the probs scratch [B, H, M*bs] and the chunk's (max, sum of
//       exp(s - max)) to stats [B, H, S, 2];
//   (b) P.V on the same grid, launched as a programmatic dependent of (a):
//       its CTAs start while (a) runs, load their token indices and pull
//       their V rows into L2, then wait for (a)'s writes.  Each CTA folds
//       all of its row's chunk stats in one fixed order (so every CTA
//       agrees on m and l), forms P in shared memory, and writes its
//       chunk's f32 P.V to partial [B, H, S, hd].  After
//       __threadfence() the last CTA of the (slot, KV head), found by an
//       atomic ticket, sums the partials in chunk order (8 outputs a thread
//       at once, so that many loads are in flight), rounds once to dt,
//       writes out and resets its counter to 0 for the next call.  A slot
//       with one chunk writes out directly.
//   Every sum runs in a fixed order, so the result does not depend on the
//   order in which CTAs run.
// lens must be >= 0.  Inactive slots (all-null tables, len 0) read block 0
// and produce finite values that the caller discards.  The counters must be
// zero when a call starts; calls that share them must not overlap (one
// stream).
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing (scratch comes from the caller),
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;  // positions per CTA
constexpr int GMAX = 8;    // query heads per register block
constexpr int EL = 8;      // pool elements a lane loads at once

struct Params {
  const void* q;          // [B, H, hd] compute dtype
  const void* kp;         // [N, bs, Hkv, hd] pool payload
  const void* vp;
  const float* ks;        // [N, bs] per-token scales (int8 pool) or null
  const float* vs;
  const int* tables;      // [B, M]
  const int* lens;        // [B]
  float* probs;           // [B, H, M*bs] f32 scores
  float* stats;           // [B, H, S, 2] per chunk (max, sum exp(s - max))
  float* part;            // [B, H, S, hd] per chunk f32 P.V
  int* counters;          // [B * Hkv] tickets, zero between calls
  void* out;              // [B, H, hd] compute dtype
  int H, Hkv, hd, bs, M, S;
  float scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// Element i of a little-endian 32-bit word of pool payload, as f32.
template <typename KV>
__device__ __forceinline__ float elem(unsigned w, int i);
template <> __device__ __forceinline__ float elem<int8_t>(unsigned w, int i) {
  return (float)(int8_t)(w >> (8 * i));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(unsigned w, int i) {
  return __uint_as_float(i ? (w & 0xffff0000u) : (w << 16));
}
template <> __device__ __forceinline__ float elem<float>(unsigned w, int) {
  return __uint_as_float(w);
}

// EL consecutive pool elements at p (aligned to their size, at most 16
// bytes a load) as f32, through the read-only path (the pool is not
// written during a call).
template <typename KV>
__device__ __forceinline__ void load_vec(const KV* p, float (&v)[EL]) {
  constexpr int BYTES = EL * (int)sizeof(KV), WORDS = BYTES / 4;
  constexpr int PER = 4 / (int)sizeof(KV);
  static_assert(BYTES == 8 || BYTES == 16 || BYTES == 32, "vector width");
  unsigned w[WORDS];
  if constexpr (WORDS >= 4) {
#pragma unroll
    for (int h = 0; h < WORDS / 4; ++h) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + h);
      w[4 * h] = u.x; w[4 * h + 1] = u.y; w[4 * h + 2] = u.z;
      w[4 * h + 3] = u.w;
    }
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x; w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < EL; ++i) v[i] = elem<KV>(w[i / PER], i % PER);
}

// A pool element as the reference's compute-dtype value: dt(x), and for an
// int8 pool dt(dt(x) * dt(scale)).
template <typename T, bool INT8>
__device__ __forceinline__ float kv_value(float x, float sc) {
  const float v = round_dt<T>(x);
  return INT8 ? round_dt<T>(v * sc) : v;
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

// Programmatic dependent launch: (b) may start while (a) runs; it reads
// only the pool and the tables before wait_primary(), which returns once
// (a)'s writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// This CTA's chunk: positions [start, start + n) of the nvalid admitted
// (kpos <= len); n <= 0 when the chunk lies past them.
struct Chunk {
  int start, n, nc;  // first position, positions, chunks the slot admits
};
__device__ __forceinline__ Chunk chunk_of(const Params& p) {
  Chunk c;
  const int T_all = p.M * p.bs, len = p.lens[blockIdx.x];
  const int nvalid = len + 1 < T_all ? len + 1 : T_all;
  c.start = blockIdx.z * CHUNK;
  c.n = nvalid - c.start < CHUNK ? nvalid - c.start : CHUNK;
  c.nc = (nvalid + CHUNK - 1) / CHUNK;
  return c;
}

// Token index (block * bs + offset) and, for an int8 pool, the rounded
// scale of each of the chunk's positions.
template <typename T, bool INT8>
__device__ __forceinline__ void load_chunk_tokens(const Params& p,
                                                  const Chunk& c,
                                                  const float* scales,
                                                  int* tok_s, float* sc_s) {
  const int* table = p.tables + (size_t)blockIdx.x * p.M;
  for (int i = threadIdx.x; i < c.n; i += THREADS) {
    const int t = c.start + i;
    const int tok = table[t / p.bs] * p.bs + t % p.bs;
    tok_s[i] = tok;
    if (INT8) sc_s[i] = round_dt<T>(scales[tok]);
  }
}

// Sum each of the GMAX values v[] over the L lanes of a sub-group.  A
// butterfly reduce-scatter halves the values a lane holds at each step
// (8 values over 8 lanes: 4 + 2 + 1 shuffles instead of 8 x 3), then plain
// butterfly steps finish the sum.  Afterwards a lane holds NH = GMAX / L (at
// least 1) sums, of heads *h .. *h + NH - 1, in v[0 .. NH-1]; the lanes
// whose sl % (L / GMAX) is 0 hold distinct heads.  A fixed order of adds.
template <int L>
__device__ __forceinline__ void reduce_heads(float (&v)[GMAX], int sl,
                                             int* h) {
  int n = GMAX;
  *h = 0;
#pragma unroll
  for (int o = L / 2; o >= 1; o /= 2) {
    if (n > 1) {
      const bool up = sl & o;
      const int half = n / 2;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      if (up) *h += half;
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// (a) scores of one chunk, and its (max, sum exp) per query head.  L: lanes
// a K row (a power of two, 8 to 32), each taking EL elements.
template <typename T, typename KV, int L>
__global__ void __launch_bounds__(THREADS)
paged_attention_scores_kernel(Params p) {
  constexpr bool INT8 = sizeof(KV) == 1;
  launch_dependents();
  const Chunk c = chunk_of(p);
  if (c.n <= 0) return;
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y, G = p.H / p.Hkv, hd = p.hd;
  const int T_all = p.M * p.bs;
  float* qs = smem;                                  // [G, hd]
  float* sc = qs + G * hd;                           // [G, CHUNK]
  float* ksc = sc + G * CHUNK;                       // [CHUNK]
  int* tok_s = reinterpret_cast<int*>(ksc + CHUNK);  // [CHUNK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.H + g * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) qs[i] = to_f(q[i]);
  load_chunk_tokens<T, INT8>(p, c, p.ks, tok_s, ksc);
  __syncthreads();

  // a sub-group of L lanes per K row, lane sl taking vectors sl, sl+L, ...;
  // the q columns of vector sl stay in registers for GMAX heads
  constexpr int rows = 32 / L, NH = GMAX / L > 1 ? GMAX / L : 1;
  constexpr int SPREAD = L / GMAX > 1 ? L / GMAX : 1;
  const int nvec = hd / EL, sl = lane % L;
  const KV* kp = static_cast<const KV*>(p.kp);
  for (int g0 = 0; g0 < G; g0 += GMAX) {
    const int gc = G - g0 < GMAX ? G - g0 : GMAX;
    float qr[GMAX][EL];
#pragma unroll
    for (int j = 0; j < GMAX; ++j)
#pragma unroll
      for (int e = 0; e < EL; ++e)
        qr[j][e] = j < gc && sl < nvec ? qs[(g0 + j) * hd + sl * EL + e] : 0.f;
#pragma unroll 4
    for (int r0 = 0; r0 < c.n; r0 += WARPS * rows) {
      const int i = r0 + warp * rows + lane / L;
      const bool ok = i < c.n;
      float dot[GMAX];
#pragma unroll
      for (int j = 0; j < GMAX; ++j) dot[j] = 0.0f;
      if (ok) {
        const KV* krow = kp + ((size_t)tok_s[i] * p.Hkv + g) * (size_t)hd;
        const float ks = INT8 ? ksc[i] : 0.0f;
        float kv[EL];
        if (sl < nvec) {
          load_vec<KV>(krow + sl * EL, kv);
#pragma unroll
          for (int e = 0; e < EL; ++e) {
            const float k = kv_value<T, INT8>(kv[e], ks);
#pragma unroll
            for (int j = 0; j < GMAX; ++j) dot[j] = fmaf(qr[j][e], k, dot[j]);
          }
        }
        // rows wider than 32 vectors
        for (int v = sl + L; v < nvec; v += L) {
          load_vec<KV>(krow + v * EL, kv);
#pragma unroll
          for (int e = 0; e < EL; ++e) {
            const float k = kv_value<T, INT8>(kv[e], ks);
            for (int j = 0; j < gc; ++j)
              dot[j] = fmaf(qs[(g0 + j) * hd + v * EL + e], k, dot[j]);
          }
        }
      }
      int h;
      reduce_heads<L>(dot, sl, &h);
      if (ok && sl % SPREAD == 0)
#pragma unroll
        for (int u = 0; u < NH; ++u)
          if (h + u < gc) sc[(g0 + h + u) * CHUNK + i] = dot[u] * p.scale;
    }
  }
  __syncthreads();

  // the chunk's scores to probs; its (max, sum exp(s - max)) to stats
  float* probs = p.probs + ((size_t)b * p.H + (size_t)g * G) * T_all;
  for (int e = tid; e < G * c.n; e += THREADS) {
    const int gi = e / c.n, i = e % c.n;
    probs[(size_t)gi * T_all + c.start + i] = sc[gi * CHUNK + i];
  }
  for (int gi = warp; gi < G; gi += WARPS) {
    const float* row = sc + gi * CHUNK;
    float m = -INFINITY;
    for (int i = lane; i < c.n; i += 32) m = fmaxf(m, row[i]);
    m = warp_max(m);
    float l = 0.0f;
    for (int i = lane; i < c.n; i += 32) l += expf(row[i] - m);
    l = warp_sum(l);
    if (lane == 0) {
      float* st = p.stats +
          (((size_t)b * p.H + (size_t)g * G + gi) * p.S + blockIdx.z) * 2;
      st[0] = m;
      st[1] = l;
    }
  }
}

// (b) P = dt(exp(s - m) / l) for one chunk and its P.V; the last CTA of
// the (slot, KV head) sums the chunks' partials into out.
template <typename T, typename KV>
__global__ void __launch_bounds__(THREADS)
paged_attention_pv_kernel(Params p) {
  constexpr bool INT8 = sizeof(KV) == 1;
  const Chunk c = chunk_of(p);
  if (c.n <= 0) return;
  extern __shared__ float smem[];
  __shared__ int last;
  const int b = blockIdx.x, g = blockIdx.y, G = p.H / p.Hkv, hd = p.hd;
  const int T_all = p.M * p.bs;
  const int TPR = hd / EL, NS = THREADS / TPR;  // threads a row, slices
  float* ps = smem;                              // [G, CHUNK]
  float* mrow = ps + G * CHUNK;                  // [G]
  float* lrow = mrow + G;                        // [G]
  float* vsc = lrow + G;                         // [CHUNK]
  float* red = vsc + CHUNK;                      // [NS, GMAX, hd]
  int* tok_s = reinterpret_cast<int*>(red + NS * GMAX * hd);  // [CHUNK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)b * p.H + (size_t)g * G;  // first query head
  const KV* vp = static_cast<const KV*>(p.vp);
  const int ts = tid / TPR, vi = tid % TPR;
  load_chunk_tokens<T, INT8>(p, c, p.vs, tok_s, vsc);
  __syncthreads();
  // while (a) finishes: bring this thread's V vectors into L2
  if (ts < NS)
    for (int i = ts; i < c.n; i += NS)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          vp + ((size_t)tok_s[i] * p.Hkv + g) * (size_t)hd + vi * EL));
  wait_primary();
  // the chunk's scores into ps, in flight while the stats are folded
  for (int e = tid; e < G * c.n; e += THREADS) {
    const int gi = e / c.n, i = e % c.n;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(ps + gi * CHUNK + i)),
                 "l"(p.probs + (row0 + gi) * T_all + c.start + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // fold the row's chunk stats in chunk order: m, then l = sum l_k e^(m_k-m)
  for (int gi = warp; gi < G; gi += WARPS) {
    const float* st = p.stats + (row0 + gi) * p.S * 2;
    float m = -INFINITY;
    for (int k = lane; k < c.nc; k += 32) m = fmaxf(m, st[2 * k]);
    m = warp_max(m);
    float l = 0.0f;
    for (int k = lane; k < c.nc; k += 32)
      l += st[2 * k + 1] * expf(st[2 * k] - m);
    l = warp_sum(l);
    if (lane == 0) {
      mrow[gi] = m;
      lrow[gi] = l;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int e = tid; e < G * c.n; e += THREADS) {
    const int gi = e / c.n, i = e % c.n;
    float* pe = ps + gi * CHUNK + i;
    *pe = round_dt<T>(expf(*pe - mrow[gi]) / lrow[gi]);
  }
  __syncthreads();

  // P.V: thread (slice ts, columns vi*EL ..) over positions ts, ts+NS, ...
  T* out = static_cast<T*>(p.out);
  for (int g0 = 0; g0 < G; g0 += GMAX) {
    const int gc = G - g0 < GMAX ? G - g0 : GMAX;
    if (ts < NS) {
      float acc[GMAX][EL];
#pragma unroll
      for (int j = 0; j < GMAX; ++j)
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[j][e] = 0.0f;
#pragma unroll 4
      for (int i = ts; i < c.n; i += NS) {
        float v[EL];
        load_vec<KV>(vp + ((size_t)tok_s[i] * p.Hkv + g) * (size_t)hd +
                             vi * EL, v);
        const float vs = INT8 ? vsc[i] : 0.0f;
#pragma unroll
        for (int e = 0; e < EL; ++e) v[e] = kv_value<T, INT8>(v[e], vs);
#pragma unroll
        for (int j = 0; j < GMAX; ++j)
          if (j < gc) {
            const float pj = ps[(g0 + j) * CHUNK + i];
#pragma unroll
            for (int e = 0; e < EL; ++e) acc[j][e] = fmaf(pj, v[e], acc[j][e]);
          }
      }
#pragma unroll
      for (int j = 0; j < GMAX; ++j)
        if (j < gc)
#pragma unroll
          for (int e = 0; e < EL; ++e)
            red[(ts * GMAX + j) * hd + vi * EL + e] = acc[j][e];
    }
    __syncthreads();
    for (int e = tid; e < gc * hd; e += THREADS) {
      const int j = e / hd, d = e % hd;
      float s = 0.0f;
      for (int k = 0; k < NS; ++k) s += red[(k * GMAX + j) * hd + d];
      const size_t row = row0 + g0 + j;
      if (c.nc == 1)
        out[row * hd + d] = from_f<T>(s);
      else
        p.part[(row * p.S + blockIdx.z) * hd + d] = s;
    }
    __syncthreads();
  }
  if (c.nc == 1) return;

  // the last of the slot's nc CTAs sums the partials in chunk order
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (size_t)b * p.Hkv + g;
  if (tid == 0) last = atomicAdd(counter, 1) == c.nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // OUTS outputs a thread at once, each summed in chunk order, so that
  // OUTS x 4 loads are in flight
  constexpr int OUTS = 8;
  for (int e0 = 0; e0 < G * hd; e0 += OUTS * THREADS) {
    float s[OUTS];
    const float* pr[OUTS];
#pragma unroll
    for (int r = 0; r < OUTS; ++r) {
      const int e = e0 + r * THREADS + tid;
      s[r] = 0.0f;
      pr[r] = e < G * hd ? p.part + (row0 + e / hd) * p.S * hd + e % hd
                         : nullptr;
    }
#pragma unroll 4
    for (int k = 0; k < c.nc; ++k)
#pragma unroll
      for (int r = 0; r < OUTS; ++r)
        if (pr[r]) s[r] += __ldcg(pr[r] + (size_t)k * hd);
#pragma unroll
    for (int r = 0; r < OUTS; ++r)
      if (pr[r]) {
        const int e = e0 + r * THREADS + tid;
        out[(row0 + e / hd) * hd + e % hd] = from_f<T>(s[r]);
      }
  }
  if (tid == 0) *counter = 0;
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The scores kernel for nvec vectors a row: the smallest sub-group of 8 to
// 32 lanes that covers the row (rows of more than 32 vectors loop).
template <typename T, typename KV>
auto scores_kernel(int nvec) {
  return nvec > 16  ? paged_attention_scores_kernel<T, KV, 32>
         : nvec > 8 ? paged_attention_scores_kernel<T, KV, 16>
                    : paged_attention_scores_kernel<T, KV, 8>;
}

template <typename T, typename KV>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const dim3 grid(B, p.Hkv, p.S);
  const size_t smem_a =
      sizeof(float) * ((size_t)G * p.hd + (size_t)G * CHUNK + 2 * CHUNK);
  void (*scores)(Params) = scores_kernel<T, KV>(p.hd / EL);
  int err = set_smem(scores, smem_a);
  if (err) return err;
  scores<<<grid, THREADS, smem_a, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int ns = THREADS / (p.hd / EL);
  const size_t smem_b = sizeof(float) *
      ((size_t)G * CHUNK + 2 * G + 2 * CHUNK + (size_t)ns * GMAX * p.hd);
  void (*pv)(Params) = paged_attention_pv_kernel<T, KV>;
  err = set_smem(pv, smem_b);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_b;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, pv, p);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// kv_kind: 0 = f32 pool, 1 = bf16 pool, 2 = int8 pool with per-token scales.
// S must be ceil(M * bs / 64); probs [B, H, M*bs], stats [B, H, S, 2] and
// part [B, H, S, hd] are f32 scratch; counters [B * Hkv] int32, zero.
extern "C" int paged_attention_launch(
    const void* q, const void* kp, const void* vp, const float* ks,
    const float* vs, const int* tables, const int* lens, float* probs,
    float* stats, float* part, int* counters, void* out, int B, int H,
    int Hkv, int hd, int bs, int M, int S, float scale, int q_bf16,
    int kv_kind, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || bs <= 0 || M <= 0 || hd <= 0 ||
      S != (M * bs + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  // EL-element vectors: hd a multiple of EL and the bases aligned to a
  // vector (at most 16 bytes; the row offsets are multiples of hd
  // elements); a P.V row covered by the 128 threads
  const int esz = kv_kind == 0 ? 4 : kv_kind == 1 ? 2 : 1;
  const uintptr_t align = EL * esz < 16 ? EL * esz : 16;
  if (hd % EL != 0 || hd / EL > THREADS || (uintptr_t)kp % align != 0 ||
      (uintptr_t)vp % align != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.kp = kp; p.vp = vp;
  p.ks = ks; p.vs = vs;
  p.tables = tables; p.lens = lens;
  p.probs = probs; p.stats = stats; p.part = part; p.counters = counters;
  p.out = out;
  p.H = H; p.Hkv = Hkv; p.hd = hd; p.bs = bs; p.M = M; p.S = S;
  p.scale = scale;
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
