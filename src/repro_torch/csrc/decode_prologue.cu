// decode_prologue: RMSNorm + Q/K/V projections (+ bias) + RoPE for one decode
// token per slot, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_prologue.py::_call_kernel, the Pallas
// TPU kernel body _kernel running _prologue_rows (emulate: f32 master weights
// cast to the compute dtype) or _prologue_rows_int8 (int8 weights with
// per-tensor scales, per-row activation absmax, int32 MACs, one rescale).
//
// What bounds it on this card: the weights.  x is [B, D] with B the slot
// count (8), and every weight is used by B rows only, so a call reads
// D * (H + 2*Hkv) * hd weights once (12.6 MB of f32 masters a layer at
// qwen1.5-0.5b width, 3.1 MB as int8; 264 MB and 66 MB at yi-34b width) and
// is bound by those bytes.  At qwen width that is 1-4 us of HBM time, so
// the latency of the rows' norm, of the first tiles and of the split's sum
// in the cluster weigh as much as the rate.
//
// The design (the launch comes from kernels/decode_prologue.py::_plan):
// * The rows once.  A small first kernel (prologue_rows_kernel, one CTA a
//   row) stages the row and nscale in shared memory with one round of
//   16-byte copies, sums its squares in one fixed order, norms it as the
//   reference does ((x * inv) * scale rounded to the compute dtype), and
//   int8: quantizes it by its absmax; it writes the result k-major in the
//   main kernel's tile layout to scratch.  The main kernel is its
//   programmatic dependent: its CTAs start and put W's first tiles in
//   flight while the rows are summed, then wait (griddepcontrol.wait).
//   Every CTA reads the same normed rows, so the int8 payloads and scales
//   do not depend on the split.
// * One column space, strips that keep RoPE pairs local.  The q, k and v
//   projections are one space of (H + 2*Hkv) heads.  A CTA owns a strip
//   inside one head: up to 32 rotation pairs (j, j + hd/2), i.e. columns
//   j0 .. j0+31 and hd/2 + j0 .. hd/2 + j0+31 of the head, 64 columns in
//   all; hd = 120 gives strips of 32 and 28 pairs, hd = 256 four strips.
//   v strips use the same layout without the rotation.
// * Fill the SMs.  Where the strips are too few for the SMs (48 at qwen
//   width), the grid's z axis splits D into S tile-aligned ranges (S a
//   power of two <= 8, the portable cluster size) and the S CTAs of a strip
//   form a thread-block cluster that sums their partials in distributed
//   shared memory in rank order (cluster_push, then each CTA finishes MR/S
//   rows).  int32 partials stay int32 to the rescale, so int8 is bitwise
//   the same for every S.
// * Stream W and the rows together.  A 4-stage cp.async ring whose stages
//   hold an 8 KB tile of W (32 f32 or 128 int8 k-rows of the strip's 64
//   columns, copied in 16-byte pieces where the head's halves allow, else
//   4-byte pieces or single int8 bytes) and the normed rows' tile for the
//   same k-rows.  A thread owns 4 columns and every 16th k-row (int8:
//   k-quad) of a tile; int8 runs __dp4a on W's 4x4 byte squares transposed
//   by __byte_perm, emulate rounds each weight once, in registers.
// * Epilogue.  After the cluster's sum each CTA owns whole rows of the
//   strip: rescale (int8), bias, RoPE with 1/powf(theta, j/half) and
//   cosf/sinf, stores in the compute dtype.
// * Rows.  A pass takes 8 or 16 rows (the template's MR); grid.y walks the
//   passes, so B <= 16 reads W once and B > 16 once a pass.
// Tried on the H100 and dropped: the first port's one CTA a head (48 CTAs,
// 1- or 4-byte loads, the whole normed [RB, D] in shared memory, so 8 yi-34b
// slots took two passes over W); each CTA norming its own rows (every CTA
// re-read the whole rows twice, which dominated at yi-34b width); each CTA
// norming and quantizing every streamed tile (the same divides 144 times
// over); 6 or 8 ring stages, and each strip starting its walk over D at
// another tile (no faster at either width); int8 strips of four units, 256
// contiguous bytes of a W row a CTA as f32's one unit reads (no faster at
// yi-34b width).  Still open: int8 at yi-34b width runs at ~2.7x its bound and
// about as fast with its products removed.
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SN = 64;               // columns a strip
constexpr int PAIRS = SN / 2;        // rotation pairs a strip
constexpr int CQ = SN / 4;           // column quads: threads along the strip
constexpr int KG = THREADS / CQ;     // k-groups: threads along K
constexpr int TILE_BYTES = 8192;     // W a ring stage (unpadded)
constexpr int STAGES = 4;
constexpr int MAX_SPLITS = 8;        // the portable cluster size
constexpr int SMEM_MAX = 232448;     // shared memory a CTA may have
constexpr int ROWS_SMEM = 96 * 1024; // the rows kernel's staged row, at most

struct Params {
  const void* x;             // [B, D] compute dtype
  const float* nscale;       // [D]
  const void* w[3];          // [D, nh*hd] f32 masters or int8 payloads
  const float* wscale;       // [3] per-tensor scales (int8 only)
  const float* bias[3];      // [nh*hd] f32 or null
  const int* pos;            // [B]
  void* out[3];              // [B, nh, hd] compute dtype
  void* xp;                  // [passes, Dp, MR] the normed rows, k-major
  float* sx;                 // [passes * MR] each row's activation scale
  int B, D, H, Hkv, hd, half, sph;   // sph: strips a head
  int use_rope, S, vx, wp;   // vx: 16-byte x rows; wp: bytes a W copy
  int Dp;                    // D rounded up to whole W tiles
  int rows_smem;             // the rows kernel stages a row in smem
  float theta, eps;
};

template <bool I8>
struct Tile {                        // W's tile of a ring stage
  static constexpr int ELEM = I8 ? 1 : 4;
  static constexpr int BKR = TILE_BYTES / (SN * ELEM);   // k-rows a tile
  static constexpr int PITCH = SN * ELEM + 16;           // bytes a row
  static constexpr int STAGE = BKR * PITCH;
};

// A ring stage: W's tile, then the normed rows' tile (xc, k-major) for the
// same k-rows.  Shared memory: ring | part (the cluster's inbox) | sx.
template <typename T, bool I8, int MR>
struct Smem {
  using L = Tile<I8>;
  static constexpr int XC = L::BKR * MR * (I8 ? 1 : (int)sizeof(T));
  static constexpr int STAGE = L::STAGE + XC;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PART = MR * SN * 4;
  static constexpr int TOTAL = RING + PART + MR * 4;
  static_assert(RING >= WARPS * MR * SN * 4, "ring holds the warp sums");
  static_assert(TOTAL <= SMEM_MAX, "fits a CTA");
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the normed value of one x, rounded to the compute dtype, as the
// reference rounds it: (x * inv) * scale, no contraction
template <typename T>
__device__ __forceinline__ float normed(float x, float inv, float ns) {
  return round_dt<T>(__fmul_rn(__fmul_rn(x, inv), ns));
}

// 16 bytes of x (4 f32 or 8 bf16) as f32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4 u, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  } else {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One strip's W: its two 32-column halves (colA, colB of a row of ncols)
// for k-rows [k0, k0 + BKR) into one ring stage; zero past D and past the
// strip's np pairs.  wp: bytes a copy (16 or 4 by cp.async, 1 by plain
// byte loads, int8 only).
template <bool I8>
__device__ __forceinline__ void stage_w(unsigned char* dst,
                                        const unsigned char* w, int ncols,
                                        int D, int k0, int colA, int colB,
                                        int np, int wp) {
  using L = Tile<I8>;
  constexpr int E = L::ELEM;
  if (wp == 16) {
    constexpr int PPS = PAIRS * E / 16;         // pieces a half-row
    constexpr int PPR = 2 * PPS;
    static_assert(L::BKR * PPR % THREADS == 0, "whole pieces a thread");
#pragma unroll
    for (int i = 0; i < L::BKR * PPR / THREADS; ++i) {
      const int e = i * THREADS + (int)threadIdx.x;
      const int r = e / PPR, c = e % PPR, seg = c / PPS;
      const int ci = (c % PPS) * (16 / E), gk = k0 + r;
      const bool ok = gk < D && ci < np;
      const unsigned char* src =
          w + ((size_t)gk * ncols + (seg ? colB : colA) + ci) * E;
      cp16(dst + r * L::PITCH + (seg * PAIRS + ci) * E, ok ? src : w,
           ok ? 16 : 0);
    }
  } else if (wp == 4) {
    constexpr int PPS = PAIRS * E / 4;
    constexpr int PPR = 2 * PPS;
#pragma unroll 4
    for (int e = threadIdx.x; e < L::BKR * PPR; e += THREADS) {
      const int r = e / PPR, c = e % PPR, seg = c / PPS;
      const int ci = (c % PPS) * (4 / E), gk = k0 + r;
      const bool ok = gk < D && ci < np;
      const unsigned char* src =
          w + ((size_t)gk * ncols + (seg ? colB : colA) + ci) * E;
      cp4(dst + r * L::PITCH + (seg * PAIRS + ci) * E, ok ? src : w,
          ok ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < L::BKR * SN; e += THREADS) {
      const int r = e / SN, c = e % SN, seg = c / PAIRS, ci = c % PAIRS;
      const int gk = k0 + r;
      const bool ok = gk < D && ci < np;
      dst[r * L::PITCH + c] =
          ok ? w[(size_t)gk * ncols + (seg ? colB : colA) + ci] : 0;
    }
  }
}

// ------------------------------------------------------- the cluster sum

// A barrier phase arrived at when the kernel starts and waited for before
// the first push into a peer, so that every peer runs before its memory is
// written.
__device__ __forceinline__ void cluster_start() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_ready() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename Acc> struct Vec4;
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int> { using T = int4; };

// Entries e .. e+3 of this CTA's [MR][SN] partial into the inbox of the CTA
// that finishes them (CTA r finishes the r-th 1/S of the rows), at slot
// [own rank]: a store to its shared memory.
template <typename Acc>
__device__ __forceinline__ void cluster_push(Acc* inbox, int E, int e,
                                            typename Vec4<Acc>::T v) {
  cg::cluster_group cl = cg::this_cluster();
  const int per = E / (int)cl.num_blocks();      // powers of two
  const int sh = __ffs(per) - 1;
  Acc* dst = cl.map_shared_rank(inbox, e >> sh) +
             ((int)cl.block_rank() << sh) + (e & (per - 1));
  *reinterpret_cast<typename Vec4<Acc>::T*>(dst) = v;
}

// ---------------------------------------------------------------- kernels

// The rows once, for every strip: row r of pass y (one CTA; rows past B
// write zeros) normed as the reference norms it, (x * inv) * scale rounded
// to the compute dtype with inv = 1/sqrt(mean(x^2) + eps); int8 then
// quantizes it by sx = its absmax / 127 (1 where 0).  The sums run in one
// fixed order, so the result does not depend on the main launch's split.
// Written k-major for the main launch's tiles: xp[y][k/4][MR] words of 4
// consecutive int8 k, else xp[y][k][MR] in the compute dtype; zero past D
// up to Dp.  The main launch is its programmatic dependent: it starts
// streaming W while these rows are summed.
template <typename T, bool I8, int MR>
__global__ void __launch_bounds__(THREADS) prologue_rows_kernel(Params p) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char rsm[];
  __shared__ float red[WARPS];
  __shared__ float bcast;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x, r = row % MR;
  const size_t base = (size_t)(row / MR) * p.Dp * MR;
  unsigned* xw = static_cast<unsigned*>(p.xp) + base / 4;
  T* xt = static_cast<T*>(p.xp) + base;
  if (row >= p.B) {
    for (int q = tid; q < p.Dp / 4; q += THREADS) {
      if constexpr (I8) {
        xw[q * MR + r] = 0u;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) xt[(4 * q + i) * MR + r] = from_f<T>(0.0f);
      }
    }
    return;
  }
  // the row and nscale: staged in shared memory by one round of 16-byte
  // copies where the launch gave room (rows_smem), else read in place
  const T* xr = static_cast<const T*>(p.x) + (size_t)row * p.D;
  const float* ns = p.nscale;
  if (p.rows_smem) {
    constexpr int PE = 16 / (int)sizeof(T);
    for (int i = tid; i < p.D / PE; i += THREADS)
      cp16(rsm + 16 * i, xr + (size_t)i * PE, 16);
    unsigned char* nsm = rsm + (size_t)p.D * sizeof(T);
    for (int i = tid; i < p.D / 4; i += THREADS)
      cp16(nsm + 16 * i, ns + 4 * i, 16);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    xr = reinterpret_cast<const T*>(rsm);
    ns = reinterpret_cast<const float*>(nsm);
  }
  // the sum of squares: thread-strided quads, then warps in order
  float ss = 0.0f;
  for (int k = 4 * tid; k < p.D; k += 4 * THREADS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = k + i < p.D ? to_f(xr[k + i]) : 0.0f;
      ss += v * v;
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.0f;
    for (int w = 0; w < WARPS; ++w) t += red[w];
    bcast = 1.0f / sqrtf(t / (float)p.D + p.eps);
  }
  __syncthreads();
  const float inv = bcast;
  // k .. k+3 of the row, normed (zero past D)
  auto quad = [&](int k, float* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = k + i < p.D ? normed<T>(to_f(xr[k + i]), inv, ns[k + i]) : 0.0f;
  };
  float s = 1.0f;
  if constexpr (I8) {
    float amax = 0.0f;
    for (int q = tid; q < p.Dp / 4; q += THREADS) {
      float v[4];
      quad(4 * q, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
    amax = warp_max(amax);
    __syncthreads();               // red's sums have been read
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    if (tid == 0) {
      float m = 0.0f;
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[w]);
      bcast = m > 0.0f ? m / 127.0f : 1.0f;
      p.sx[row] = bcast;
    }
    __syncthreads();
    s = bcast;
  }
  for (int q = tid; q < p.Dp / 4; q += THREADS) {
    float v[4];
    quad(4 * q, v);
    if constexpr (I8) {
      unsigned word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qv = (int)fminf(fmaxf(rintf(v[i] / s), -127.0f), 127.0f);
        word |= ((unsigned)qv & 0xffu) << (8 * i);
      }
      xw[q * MR + r] = word;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) xt[(4 * q + i) * MR + r] = from_f<T>(v[i]);
    }
  }
}

template <typename T, bool I8, int MR>
__global__ void __launch_bounds__(THREADS, 2) prologue_kernel(Params p) {
  using L = Tile<I8>;
  using SM = Smem<T, I8, MR>;
  using Acc = typename std::conditional<I8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  Acc* part = reinterpret_cast<Acc*>(smem + SM::RING);
  float* sx_s = reinterpret_cast<float*>(smem + SM::RING + SM::PART);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cq = tid % CQ, kg = tid / CQ;
  const bool split = p.S > 1;
  if (split) cluster_start();

  // the strip: kind (q, k, v), head, first pair, pairs
  int hs = (int)blockIdx.x / p.sph, kind = 0;
  const int j0 = ((int)blockIdx.x % p.sph) * PAIRS;
  if (hs >= p.H) { hs -= p.H; kind = 1; }
  if (kind == 1 && hs >= p.Hkv) { hs -= p.Hkv; kind = 2; }
  const int nh = kind == 0 ? p.H : p.Hkv, ncols = nh * p.hd;
  const int np = min(PAIRS, p.half - j0);
  const int colA = hs * p.hd + j0, colB = colA + p.half;
  const unsigned char* w = static_cast<const unsigned char*>(p.w[kind]);

  // this split's tiles [t0, t0 + nt) of Dp / BKR
  const int ntot = p.Dp / L::BKR;
  const int t0 = (int)blockIdx.z * ntot / p.S;
  const int nt = ((int)blockIdx.z + 1) * ntot / p.S - t0;
  const int k0 = t0 * L::BKR;
  const int r0 = (int)blockIdx.y * MR;
  // this pass's normed rows, from tile t0 on
  const unsigned char* xp = static_cast<const unsigned char*>(p.xp) +
                            ((size_t)blockIdx.y * p.Dp + k0) * SM::XC /
                                L::BKR;
  auto stage_xc = [&](int s, int t) {
    unsigned char* dst = ring + s * SM::STAGE + L::STAGE;
    const unsigned char* src = xp + (size_t)t * SM::XC;
    for (int c = tid; c < SM::XC / 16; c += THREADS)
      cp16(dst + 16 * c, src + 16 * c, 16);
  };

  // W's first tiles in flight while the rows kernel runs; then the rows'
  // first tiles, in the first commit group with them
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nt)
      stage_w<I8>(ring + s * SM::STAGE, w, ncols, p.D, k0 + s * L::BKR, colA,
                  colB, np, p.wp);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) stage_xc(s, s);
    cp_commit();
  }
  if (tid < MR) sx_s[tid] = r0 + tid < p.B ? p.sx[r0 + tid] : 1.0f;

  // 1. the strip's products over this split's tiles
  Acc acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  for (int t = 0; t < nt; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();               // stage t landed; stage t-1 is free
    if (t + STAGES - 1 < nt) {
      const int s = (t + STAGES - 1) % STAGES;
      stage_w<I8>(ring + s * SM::STAGE, w, ncols, p.D,
                  k0 + (t + STAGES - 1) * L::BKR, colA, colB, np, p.wp);
      stage_xc(s, t + STAGES - 1);
    }
    cp_commit();
    const unsigned char* st = ring + (t % STAGES) * SM::STAGE;
    const unsigned char* xc = st + L::STAGE;
    const unsigned char* wt = st + cq * 4 * L::ELEM;
    if constexpr (I8) {
      const int* xw = reinterpret_cast<const int*>(xc);
#pragma unroll
      for (int i = 0; i < L::BKR / 4 / KG; ++i) {
        const int q = i * KG + kg;            // k-quad of the tile
        const unsigned char* pw = wt + 4 * q * L::PITCH;
        const unsigned w0 = *reinterpret_cast<const unsigned*>(pw);
        const unsigned w1 = *reinterpret_cast<const unsigned*>(pw + L::PITCH);
        const unsigned w2 =
            *reinterpret_cast<const unsigned*>(pw + 2 * L::PITCH);
        const unsigned w3 =
            *reinterpret_cast<const unsigned*>(pw + 3 * L::PITCH);
        // the 4x4 byte square transposed: column c, k-rows 4q .. 4q+3
        const unsigned u0 = __byte_perm(w0, w1, 0x5140);
        const unsigned u1 = __byte_perm(w2, w3, 0x5140);
        const unsigned u2 = __byte_perm(w0, w1, 0x7362);
        const unsigned u3 = __byte_perm(w2, w3, 0x7362);
        const int wc[4] = {(int)__byte_perm(u0, u1, 0x5410),
                           (int)__byte_perm(u0, u1, 0x7632),
                           (int)__byte_perm(u2, u3, 0x5410),
                           (int)__byte_perm(u2, u3, 0x7632)};
        const int* xq = xw + q * MR;
#pragma unroll
        for (int m4 = 0; m4 < MR; m4 += 4) {
          const int4 xv = *reinterpret_cast<const int4*>(xq + m4);
          const int xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m4 + j][c] = __dp4a(xm[j], wc[c], acc[m4 + j][c]);
        }
      }
    } else {
      const T* xt = reinterpret_cast<const T*>(xc);
#pragma unroll
      for (int i = 0; i < L::BKR / KG; ++i) {
        const int kk = i * KG + kg;           // k-row of the tile
        const float4 w4 = *reinterpret_cast<const float4*>(wt + kk * L::PITCH);
        const float wv[4] = {round_dt<T>(w4.x), round_dt<T>(w4.y),
                             round_dt<T>(w4.z), round_dt<T>(w4.w)};
        const uint4* xr = reinterpret_cast<const uint4*>(xt + kk * MR);
#pragma unroll
        for (int m0 = 0; m0 < MR; m0 += 16 / (int)sizeof(T)) {
          float xm[16 / sizeof(T)];
          unpack16<T>(xr[m0 * (int)sizeof(T) / 16], xm);
#pragma unroll
          for (int j = 0; j < 16 / (int)sizeof(T); ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m0 + j][c] = fmaf(xm[j], wv[c], acc[m0 + j][c]);
        }
      }
    }
  }

  // 2. the k-groups: those of a warp (lanes l, l + CQ) by a shuffle, then
  //    the 8 warps' sums (in the ring, free now) in warp order
  cp_wait<0>();
  __syncthreads();
  Acc* red = reinterpret_cast<Acc*>(ring);        // [WARPS][MR][SN]
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    Acc v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = acc[m][c];
#pragma unroll
      for (int off = CQ; off < 32; off *= 2)
        v[c] += __shfl_xor_sync(0xffffffffu, v[c], off);
    }
    if (lane < CQ) {
      Acc* d = red + (warp * MR + m) * SN + cq * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) d[c] = v[c];
    }
  }
  __syncthreads();
  if (split) cluster_ready();
  using V4 = typename Vec4<Acc>::T;
  for (int e = 4 * tid; e < MR * SN; e += 4 * THREADS) {
    V4 v = *reinterpret_cast<const V4*>(red + e);
#pragma unroll
    for (int wi = 1; wi < WARPS; ++wi) {
      const V4 u = *reinterpret_cast<const V4*>(red + wi * MR * SN + e);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    if (split)
      cluster_push<Acc>(part, MR * SN, e, v);
    else
      *reinterpret_cast<V4*>(part + e) = v;
  }
  int rank = 0;
  if (split) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();                     // every push has landed
    rank = (int)cl.block_rank();
  } else {
    __syncthreads();
  }

  // 3. this CTA's rows of the strip (MR/S of them), summed over the S
  //    slots in rank order: rescale, bias, RoPE, store
  const int per = MR * SN / p.S, rows = per / SN, rb = rank * rows;
  const float wsc = I8 ? p.wscale[kind] : 1.0f;
  const float* bias = p.bias[kind];
  T* out = static_cast<T*>(p.out[kind]);
  for (int i = tid; i < rows * PAIRS; i += THREADS) {
    const int rr = i / PAIRS, c = i % PAIRS, r = rb + rr, row = r0 + r;
    if (c >= np || row >= p.B) continue;
    Acc ta = 0, tb = 0;
    for (int s = 0; s < p.S; ++s) {
      ta += part[s * per + rr * SN + c];
      tb += part[s * per + rr * SN + PAIRS + c];
    }
    float va, vb;
    if constexpr (I8) {
      const float sc = sx_s[r] * wsc;
      va = round_dt<T>((float)ta * sc);
      vb = round_dt<T>((float)tb * sc);
    } else {
      va = round_dt<T>(ta);
      vb = round_dt<T>(tb);
    }
    const int ja = j0 + c, jb = p.half + j0 + c;   // columns in the head
    if (bias != nullptr) {
      va = round_dt<T>(va + round_dt<T>(bias[hs * p.hd + ja]));
      vb = round_dt<T>(vb + round_dt<T>(bias[hs * p.hd + jb]));
    }
    T* o = out + ((size_t)row * nh + hs) * p.hd;
    if (p.use_rope && kind < 2) {
      const float freq = 1.0f / powf(p.theta, (float)ja / (float)p.half);
      const float ang = (float)p.pos[row] * freq;
      const float cs = cosf(ang), sn = sinf(ang);
      o[ja] = from_f<T>(__fsub_rn(__fmul_rn(va, cs), __fmul_rn(vb, sn)));
      o[jb] = from_f<T>(__fadd_rn(__fmul_rn(va, sn), __fmul_rn(vb, cs)));
    } else {
      o[ja] = from_f<T>(va);
      o[jb] = from_f<T>(vb);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename T, bool I8, int MR>
int launch(const Params& p, cudaStream_t stream) {
  const int passes = (p.B + MR - 1) / MR;
  Params q = p;
  const size_t rsm = (size_t)p.D * (sizeof(T) + 4);
  q.rows_smem = p.vx && rsm <= (size_t)ROWS_SMEM;
  auto rows = prologue_rows_kernel<T, I8, MR>;
  cudaError_t e = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM);
  if (e != cudaSuccess) return (int)e;
  rows<<<passes * MR, THREADS, q.rows_smem ? rsm : 0, stream>>>(q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int smem = Smem<T, I8, MR>::TOTAL;
  auto kern = prologue_kernel<T, I8, MR>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.H + 2 * p.Hkv) * p.sph, passes, p.S);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = p.S;
  cfg.attrs = attr;
  cfg.numAttrs = p.S > 1 ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, kern, q);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const Params& p, int int8, int rows, cudaStream_t stream) {
  if (int8)
    return rows == 8 ? launch<T, true, 8>(p, stream)
                     : launch<T, true, 16>(p, stream);
  return rows == 8 ? launch<T, false, 8>(p, stream)
                   : launch<T, false, 16>(p, stream);
}

}  // namespace

// S: D splits, the cluster size (a power of two <= 8, at most one a W
// tile); rows: 8 or 16 a pass; vx: 1 when the rows of x and nscale are
// whole 16-byte pieces from 16-byte aligned bases; wp: bytes a W copy (16
// or 4, or 1 for int8), which the head's halves and W's bases allow;
// xp: scratch of passes * Dp * rows bytes (int8) or elements of x (Dp: D
// rounded up to whole W tiles, 128 k-rows int8 or 32 f32), 16-byte
// aligned; sx: scratch of passes * rows f32.
extern "C" int decode_prologue_launch(
    const void* x, const float* nscale, const void* wq, const void* wk,
    const void* wv, const float* wscale, const float* bq, const float* bk,
    const float* bv, const int* pos, void* q, void* k, void* v, int B, int D,
    int H, int Hkv, int hd, int use_rope, float theta, float eps, int x_bf16,
    int int8, int S, int rows, int vx, int wp, void* xp, float* sx,
    cudaStream_t stream) {
  if (B <= 0) return 0;
  const int bkr = int8 ? Tile<true>::BKR : Tile<false>::BKR;
  const int ntot = (D + bkr - 1) / bkr;
  if (D <= 0 || hd <= 0 || hd % 2 != 0 || H <= 0 || Hkv <= 0 ||
      (rows != 8 && rows != 16) || S < 1 || S > MAX_SPLITS ||
      (S & (S - 1)) != 0 || S > ntot ||
      !(wp == 16 || wp == 4 || (wp == 1 && int8)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.nscale = nscale;
  p.w[0] = wq; p.w[1] = wk; p.w[2] = wv;
  p.wscale = wscale;
  p.bias[0] = bq; p.bias[1] = bk; p.bias[2] = bv;
  p.pos = pos;
  p.out[0] = q; p.out[1] = k; p.out[2] = v;
  p.xp = xp; p.sx = sx;
  p.B = B; p.D = D; p.H = H; p.Hkv = Hkv; p.hd = hd; p.half = hd / 2;
  p.sph = (p.half + PAIRS - 1) / PAIRS;
  p.use_rope = use_rope; p.S = S; p.vx = vx; p.wp = wp;
  p.Dp = ntot * bkr;
  p.rows_smem = 0;
  p.theta = theta; p.eps = eps;
  typedef __nv_bfloat16 bf16;
  return x_bf16 ? launch_rows<bf16>(p, int8, rows, stream)
                : launch_rows<float>(p, int8, rows, stream);
}
