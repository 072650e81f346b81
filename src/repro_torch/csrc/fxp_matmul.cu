// fxp_matmul: fixed-point (I,F) matmul + fused activation, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fxp_matmul.py::fxp_matmul, the Pallas TPU
// kernel bodies _kernel (emulate) and _kernel_int8 (int8 MXU datapath).
//
//   emulate: Y = kq_out(act(kq_a(X) @ kq_w(W)))   X, W f32 or bf16, f32 MACs
//   int8:    Y = kq_out(act(scale * int32(Xq @ Wq)))   exact int32 accumulation
//
// with X [M, K] and W [K, N] row-major -> Y [M, N] f32.
//
// What bounds it on this card: every serving call has M <= 16 (decode at 8
// slots, prefill in chunks of 16), so each weight is read once and used by
// at most 16 rows: 2*M <= 32 operations per weight, far below the ~300
// operations per byte where the H100's arithmetic becomes the limit.  Those
// products are bound by the bytes of W (4 a weight for the f32 masters, 2
// for bf16, 1 for int8 payloads), and at these sizes (1-12 MB) by the
// latency of the first loads and of the split's sum as much as by the
// rate.  LeNet training has M = 128 or 1024: there the products are small
// and bound by operations (f32) or bytes (int8), and by how many SMs have
// work.
//
// The decode path (M <= 16; the wrapper's _plan picks the path and split):
// * Fill the SMs.  A CTA owns a strip of 64 output columns and all M rows
//   (8 or 16, the template's row count).  Where the strips alone are too
//   few for the SMs (N = 1024 gives 16), the grid's z axis splits K into
//   S tile-aligned ranges, S a power of two, and the S CTAs of a strip
//   form a thread-block cluster that sums their partials in shared memory
//   (cluster_push / cluster_finish), so a product is one launch with no
//   second pass and no scratch.
// * Keep bytes in flight.  W streams through a 4-stage cp.async ring of
//   8 KB tiles (32 f32, 64 bf16 or 128 int8 k-rows of the strip) copied in
//   16-byte pieces, neighbouring threads on neighbouring columns: three
//   tiles (24 KB) are in flight while the fourth is consumed, and two
//   CTAs fit an SM.
// * Stage X once.  The CTA's K range of X (at most 16 rows) is copied with
//   cp.async beside W's first tiles, then put k-major and rounded by kq_a
//   (int8: 4 consecutive k packed in a word) while the tiles land.  A
//   thread owns 4 columns and every 16th k-row of each tile, so each
//   weight is loaded from shared memory and rounded by kq_w once, in
//   registers (skipped when the bits are off); the 16 k-groups are summed
//   by shuffles and in shared memory, in a fixed order.
// * int8: a thread reads 4 k-rows x 4 columns of the staged tile and
//   transposes the 4x4 byte square with __byte_perm, which gives __dp4a
//   operands with 4 consecutive k; rows x 4 columns of int32 accumulators
//   (at most 64) a thread.
// * Unaligned rows (N or K that is no multiple of 16 bytes, a base off a
//   16-byte boundary): W and X are staged element by element (4-byte
//   cp.async for f32, plain loads for bf16 and int8), with masking; the
//   ragged edges are zero-filled.
// The tiled path (M > 16): 64x64 output tiles, with the same K split over
// a cluster where the tiles leave SMs idle.  int8 runs mma.sync m16n8k32
// s8.s8->s32 on 4 warps of 32x32 outputs: X's tile is staged as it is (k
// is contiguous already), W's 4x4 byte squares are transposed into a
// [n][k] tile, and two k tiles are kept in flight in registers.  emulate
// runs 4x4 f32 register tiles on 256 threads, X's tile staged k-major so
// that one 16-byte shared load feeds 4 rows, the next k tile loaded into
// registers while this one is multiplied and rounded by kq_a / kq_w as it
// is staged.
// The (I,F) rounding uses rintf (round half to even, like jnp.round; never
// roundf) on x * 2^F, which is exactly x / 2^-F.  int32 sums are exact, so
// the int8 results are bitwise the plain version's for every split.
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

constexpr int MAX_SPLITS = 16;       // CTAs a cluster (Hopper's limit)

// decode path (M <= 16)
constexpr int THREADS_D = 256;
constexpr int SN = 64;               // output columns a CTA (the strip)
constexpr int CQ = SN / 4;           // column quads: threads along N
constexpr int KG = THREADS_D / CQ;   // k-groups: threads along K
constexpr int TILE_BYTES = 8192;     // W a ring stage (unpadded)
constexpr int STAGES = 4;
constexpr int X_SMEM_MAX = 64 * 1024;  // the staged X range (the plan's cap)

// tiled path (M > 16)
constexpr int TILE = 64;             // output rows and columns a CTA
constexpr int BK_I = 64;             // k a staged tile, int8
constexpr int THREADS_I = 128;       // 2x2 warps of 32x32 outputs
constexpr int LDT = BK_I + 16;       // bytes a row of an [m or n][k] tile
constexpr int BK_F = 16;             // k a staged tile, emulate
constexpr int THREADS_F = 256;       // 16 x 16 threads of 4x4 outputs
constexpr int XP = TILE + 4;         // floats a k-row of the staged X tile

// an (I,F) grid: step 2^-F; inv = 2^F, so that x * inv is exactly x / step
struct Bits {
  int on;
  float step, inv, qmin, qmax;
};

Bits make_bits(int on, int i_bits, int f_bits) {
  Bits b;
  b.on = on;
  b.step = ldexpf(1.0f, -f_bits);
  b.inv = ldexpf(1.0f, f_bits);
  b.qmax = ldexpf(1.0f, i_bits + f_bits) - 1.0f;
  b.qmin = -ldexpf(1.0f, i_bits + f_bits);
  return b;
}

__device__ __forceinline__ float kq(float x, const Bits& b) {
  if (!b.on) return x;
  float k = fminf(fmaxf(rintf(x * b.inv), b.qmin), b.qmax);
  return k * b.step;
}

// The activation unit (kernels/common.py::act_fn), one rounding per
// PyTorch op of the plain version, so nvcc contracts nothing into an FMA
// that PyTorch rounds twice (python scalars are f32 there).
__device__ __forceinline__ float act_fn(float z, int act) {
  switch (act) {
    case 1: return fmaxf(z, 0.0f);
    case 2: return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
    case 3: return tanhf(z);
    case 4: return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
    case 5: {
      constexpr float C = 0.7978845608028654f, A = 0.044715f;
      const float z3 = __fmul_rn(__fmul_rn(__fmul_rn(A, z), z), z);
      const float t = tanhf(__fmul_rn(C, __fadd_rn(z, z3)));
      return __fmul_rn(__fmul_rn(0.5f, z), __fadd_rn(1.0f, t));
    }
    default: return z;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  const void* x;        // [M, K] f32, bf16 or int8
  const void* w;        // [K, N] f32, bf16 or int8
  const float* scale;   // int8: s_x * s_w (device scalar)
  float* y;             // [M, N] f32
  int M, N, K;
  int S;                // K splits: gridDim.z, the cluster size
  int vx, vw;           // rows of X / W are whole 16-byte pieces
  int x_bf16;           // emulate: X is bf16 (else f32)
  Bits bx, bw, bo;
  int act;
  int raw;              // int8: store the int32 sum (y is int32 [M, N])
};

// The epilogue of one output: rescale (int8), act, kq_out, store.  The
// int32 mode stores the exact int32 sum as it is (no rescale, no act, no
// rounding), for a caller that adds partial sums over ranks first.
template <typename Acc>
__device__ __forceinline__ void store_out(const Args& a, float scale, int gm,
                                          int gn, Acc v) {
  if (gm >= a.M || gn >= a.N) return;
  if constexpr (std::is_same<Acc, int>::value) {
    if (a.raw) {
      reinterpret_cast<int*>(a.y)[(size_t)gm * a.N + gn] = v;
      return;
    }
  }
  const float z = std::is_same<Acc, int>::value ? (float)v * scale : (float)v;
  a.y[(size_t)gm * a.N + gn] = kq(act_fn(z, a.act), a.bo);
}

// A K split sums its partial tiles inside the thread-block cluster (the
// CTAs of one output tile, rank = split), in one launch and without a
// second pass: each CTA pushes the r-th 1/S of its partial tile (E
// entries, row-major) into CTA r's `inbox`, at slot [own rank]; after one
// cluster barrier each CTA sums its 1/S over the S slots in rank (split)
// order, in its own shared memory, and stores it through the epilogue.
// No CTA reads a peer's memory, so none has to wait for its peers before
// it exits.  The barrier's first phase, arrived at when the kernel starts
// (cluster_start) and waited for before the first push (cluster_ready),
// makes sure that every peer runs before its memory is written.  int32
// sums are exact, so the int8 result does not depend on S.
__device__ __forceinline__ void cluster_start() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_ready() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// W (2 or 4) consecutive entries of Acc, as one access.
template <typename Acc, int W>
struct Vec;
template <> struct Vec<float, 4> { using T = float4; };
template <> struct Vec<int, 4> { using T = int4; };
template <> struct Vec<float, 2> { using T = float2; };
template <> struct Vec<int, 2> { using T = int2; };

// Entries e .. e+W-1 of this CTA's partial (e a multiple of W) into the
// inbox of the CTA that owns them, as one store to its shared memory.
template <typename Acc, int W>
__device__ __forceinline__ void cluster_push(Acc* inbox, int E, int e,
                                            typename Vec<Acc, W>::T v) {
  using V = typename Vec<Acc, W>::T;
  cg::cluster_group cl = cg::this_cluster();
  const int per = E / (int)cl.num_blocks();      // powers of two
  const int sh = __ffs(per) - 1;
  Acc* dst = cl.map_shared_rank(inbox, e >> sh) +
             ((int)cl.block_rank() << sh) + (e & (per - 1));
  *reinterpret_cast<V*>(dst) = v;
}

// After every push: this CTA's 1/S of the tile (COLS columns a row), summed
// over the S slots in rank order, through the epilogue.
template <typename Acc, int COLS>
__device__ __forceinline__ void cluster_finish(const Acc* inbox, int E,
                                              const Args& a, float scale,
                                              int m0, int n0) {
  using V = typename Vec<Acc, 4>::T;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();                       // every push has landed
  const int S = (int)cl.num_blocks(), per = E / S;
  const int e0 = (int)cl.block_rank() * per;
  for (int j = 4 * (int)threadIdx.x; j < per; j += 4 * (int)blockDim.x) {
    V t = *reinterpret_cast<const V*>(inbox + j);
    for (int k = 1; k < S; ++k) {
      const V p = *reinterpret_cast<const V*>(inbox + k * per + j);
      t.x += p.x; t.y += p.y; t.z += p.z; t.w += p.w;
    }
    const int gm = m0 + (e0 + j) / COLS, gn = n0 + (e0 + j) % COLS;
    store_out(a, scale, gm, gn, t.x);
    store_out(a, scale, gm, gn + 1, t.y);
    store_out(a, scale, gm, gn + 2, t.z);
    store_out(a, scale, gm, gn + 3, t.w);
  }
}

// This split's tiles of `bk` k-rows: [*t0, return value) of ceil(K / bk),
// the balanced partition of the tiles into S ranges (the wrapper's plan).
__device__ __forceinline__ int split_range(const Args& a, int bk, int* t0) {
  const int nt = (a.K + bk - 1) / bk;
  *t0 = (int)blockIdx.z * nt / a.S;
  return ((int)blockIdx.z + 1) * nt / a.S;
}

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

// The raw bits of one element of T (for element-wise staging).
template <typename T>
using Raw = typename std::conditional<
    sizeof(T) == 1, uint8_t,
    typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type>::type;

// ------------------------------------------------------------ decode path

template <typename TW>
struct Dec {
  static constexpr int ELEM = (int)sizeof(TW);
  static constexpr int BKR = TILE_BYTES / (SN * ELEM);  // k-rows a tile
  static constexpr int PITCH = SN * ELEM + 16;   // bytes a staged row
  static constexpr int STAGE = BKR * PITCH;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int CPR = SN * ELEM / 16;     // 16-byte pieces a row
};

template <typename TW, int MR>
struct DecSmem {
  using D = Dec<TW>;
  static constexpr bool I8 = std::is_same<TW, int8_t>::value;
  // the 8 warps' sums of their k-groups reuse the ring
  static_assert(D::RING >= 8 * MR * SN * 4, "ring holds the warp sums");
  static constexpr int PART = MR * SN * 4;
  // staged X for xrows k-rows of xe bytes: as it is (a whole number of
  // 16-byte pieces), then k-major f32, or int8 4 k a word
  __host__ __device__ static int raw_bytes(int xrows, int xe) {
    return xrows * MR * xe;
  }
  __host__ __device__ static int x_bytes(int xrows, int xe) {
    return raw_bytes(xrows, xe) + xrows * MR * (I8 ? 1 : 4);
  }
  __host__ __device__ static int total(int xrows, int xe) {
    return D::RING + PART + x_bytes(xrows, xe);
  }
};

// W rows [k0, k0 + BKR) of the strip's columns [n0, n0 + SN) into one
// ring stage, zero past K and N.
template <typename TW>
__device__ __forceinline__ void stage_w(unsigned char* dst, const TW* w,
                                        const Args& a, int k0, int n0) {
  using D = Dec<TW>;
  static_assert(D::BKR * D::CPR % THREADS_D == 0, "whole pieces a thread");
  if (a.vw) {
#pragma unroll
    for (int i = 0; i < D::BKR * D::CPR / THREADS_D; ++i) {
      const int e = i * THREADS_D + (int)threadIdx.x;
      const int r = e / D::CPR, c = e % D::CPR;
      const int gk = k0 + r, gn = n0 + c * (16 / D::ELEM);
      const bool ok = gk < a.K && gn < a.N;
      cp16(dst + r * D::PITCH + c * 16, ok ? w + (size_t)gk * a.N + gn : w,
           ok ? 16 : 0);
    }
  } else {
    using R = Raw<TW>;
    const R* wr = reinterpret_cast<const R*>(w);
    for (int e = threadIdx.x; e < D::BKR * SN; e += THREADS_D) {
      const int r = e / SN, c = e % SN;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < a.K && gn < a.N;
      unsigned char* d = dst + r * D::PITCH + c * D::ELEM;
      if constexpr (D::ELEM == 4)
        cp4(d, ok ? wr + (size_t)gk * a.N + gn : wr, ok ? 4 : 0);
      else
        *reinterpret_cast<R*>(d) = ok ? wr[(size_t)gk * a.N + gn] : R(0);
    }
  }
}

// X rows [0, MR) x k [k0, k0 + xrows) as they are, row-major, into xr
// (zero past M and K), by cp.async beside W's tiles: 16-byte pieces where
// the rows are whole pieces, else element by element (4-byte cp.async for
// f32, plain loads for bf16 and int8).  E: bytes an element.
template <int MR>
__device__ __forceinline__ void stage_x_raw(unsigned char* xr,
                                            const unsigned char* x,
                                            const Args& a, int k0, int xrows,
                                            int E) {
  if (a.vx) {
    const int cpr = xrows * E / 16;
    for (int e = threadIdx.x; e < MR * cpr; e += THREADS_D) {
      const int m = e / cpr, c = e % cpr, gk = k0 + c * (16 / E);
      const bool ok = m < a.M && gk < a.K;
      cp16(xr + (m * cpr + c) * 16, ok ? x + ((size_t)m * a.K + gk) * E : x,
           ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < MR * xrows; e += THREADS_D) {
      const int m = e / xrows, kk = e % xrows, gk = k0 + kk;
      const bool ok = m < a.M && gk < a.K;
      const unsigned char* src = x + ((size_t)m * a.K + gk) * E;
      unsigned char* d = xr + (m * xrows + kk) * E;
      if (E == 4)
        cp4(d, ok ? src : x, ok ? 4 : 0);
      else if (E == 2)
        *reinterpret_cast<uint16_t*>(d) =
            ok ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
      else
        *d = ok ? *src : (unsigned char)0;
    }
  }
}

// The staged X, k-major, into xs: f32 rounded by kq_a (xs[k][m]), or int8
// as words of 4 consecutive k (xs[k/4][m]).
template <int MR, bool I8>
__device__ __forceinline__ void convert_x(void* xs, const unsigned char* xr,
                                          const Args& a, int xrows) {
  if constexpr (I8) {
    const int* src = reinterpret_cast<const int*>(xr);
    int* dst = static_cast<int*>(xs);
    const int nq = xrows / 4;
    for (int e = threadIdx.x; e < MR * nq; e += THREADS_D) {
      const int m = e / nq, q = e % nq;
      dst[q * MR + m] = src[m * nq + q];
    }
  } else {
    const float* f32 = reinterpret_cast<const float*>(xr);
    const __nv_bfloat16* b16 = reinterpret_cast<const __nv_bfloat16*>(xr);
    float* dst = static_cast<float*>(xs);
    for (int e = threadIdx.x; e < MR * xrows; e += THREADS_D) {
      const int m = e / xrows, kk = e % xrows, i = m * xrows + kk;
      dst[kk * MR + m] = kq(a.x_bf16 ? to_f(b16[i]) : f32[i], a.bx);
    }
  }
}

template <typename TW, int MR>
__global__ void __launch_bounds__(THREADS_D, 2)
fxp_decode_kernel(Args a) {
  using D = Dec<TW>;
  using L = DecSmem<TW, MR>;
  constexpr bool I8 = L::I8;
  using Acc = typename std::conditional<I8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  Acc* part = reinterpret_cast<Acc*>(smem + D::RING);     // split inbox
  const TW* w = static_cast<const TW*>(a.w);
  const int tid = threadIdx.x, cq = tid % CQ, kg = tid / CQ;
  const int n0 = blockIdx.x * SN;
  int t0;
  const int nt = split_range(a, D::BKR, &t0) - t0;
  const int k0 = t0 * D::BKR, xrows = nt * D::BKR;
  const int xe = I8 ? 1 : a.x_bf16 ? 2 : 4;              // bytes of an x
  unsigned char* xr = smem + D::RING + L::PART;           // X as it is
  void* xs = xr + L::raw_bytes(xrows, xe);                // X k-major
  const float scale = I8 && !a.raw ? a.scale[0] : 1.0f;
  const bool split = gridDim.z > 1;
  if (split) cluster_start();

  // X, then W's first tiles, in flight together; X is put k-major (and
  // rounded) while the tiles land
  stage_x_raw<MR>(xr, static_cast<const unsigned char*>(a.x), a, k0, xrows,
                  xe);
  cp_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) stage_w<TW>(ring + s * D::STAGE, w, a, k0 + s * D::BKR, n0);
    cp_commit();
  }
  cp_wait<STAGES - 1>();
  __syncthreads();
  convert_x<MR, I8>(xs, xr, a, xrows);

  Acc acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  for (int t = 0; t < nt; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();               // tile t landed; tile t-1 is free
    if (t + STAGES - 1 < nt)
      stage_w<TW>(ring + ((t + STAGES - 1) % STAGES) * D::STAGE, w, a,
                  k0 + (t + STAGES - 1) * D::BKR, n0);
    cp_commit();
    const unsigned char* wt = ring + (t % STAGES) * D::STAGE + cq * 4 * D::ELEM;
    if constexpr (I8) {
      const int* xw = static_cast<const int*>(xs) + t * (D::BKR / 4) * MR;
#pragma unroll
      for (int i = 0; i < D::BKR / 4 / KG; ++i) {
        const int q = i * KG + kg;            // k-quad of the tile
        const unsigned char* p = wt + 4 * q * D::PITCH;
        const unsigned r0 = *reinterpret_cast<const unsigned*>(p);
        const unsigned r1 = *reinterpret_cast<const unsigned*>(p + D::PITCH);
        const unsigned r2 =
            *reinterpret_cast<const unsigned*>(p + 2 * D::PITCH);
        const unsigned r3 =
            *reinterpret_cast<const unsigned*>(p + 3 * D::PITCH);
        // the 4x4 byte square transposed: column c, k-rows 4q .. 4q+3
        const unsigned u0 = __byte_perm(r0, r1, 0x5140);
        const unsigned u1 = __byte_perm(r2, r3, 0x5140);
        const unsigned u2 = __byte_perm(r0, r1, 0x7362);
        const unsigned u3 = __byte_perm(r2, r3, 0x7362);
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
      const float* xf = static_cast<const float*>(xs) + t * D::BKR * MR;
#pragma unroll
      for (int i = 0; i < D::BKR / KG; ++i) {
        const int kk = i * KG + kg;           // k-row of the tile
        float wv[4];
        if constexpr (D::ELEM == 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(wt + kk * D::PITCH);
          wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(wt + kk * D::PITCH);
          const TW* h = reinterpret_cast<const TW*>(&v);
#pragma unroll
          for (int c = 0; c < 4; ++c) wv[c] = to_f(h[c]);
        }
        if (a.bw.on) {
#pragma unroll
          for (int c = 0; c < 4; ++c) wv[c] = kq(wv[c], a.bw);
        }
        const float* xr = xf + kk * MR;
#pragma unroll
        for (int m4 = 0; m4 < MR; m4 += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + m4);
          const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m4 + j][c] = fmaf(xm[j], wv[c], acc[m4 + j][c]);
        }
      }
    }
  }

  // the k-groups: those of a warp (lanes l, l + CQ, ...) by shuffles, then
  // the 8 warps' sums (in the ring, which is free now) in warp order
  cp_wait<0>();
  __syncthreads();
  Acc* red = reinterpret_cast<Acc*>(ring);        // [8][MR][SN]
  const int warp = tid / 32, lane = tid % 32;
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
  using V4 = typename Vec<Acc, 4>::T;
  for (int e = 4 * tid; e < MR * SN; e += 4 * THREADS_D) {
    V4 v = *reinterpret_cast<const V4*>(red + e);
#pragma unroll
    for (int wi = 1; wi < THREADS_D / 32; ++wi) {
      const V4 p = *reinterpret_cast<const V4*>(red + wi * MR * SN + e);
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    if (split) {
      cluster_push<Acc, 4>(part, MR * SN, e, v);
    } else {
      store_out(a, scale, e / SN, n0 + e % SN, v.x);
      store_out(a, scale, e / SN, n0 + e % SN + 1, v.y);
      store_out(a, scale, e / SN, n0 + e % SN + 2, v.z);
      store_out(a, scale, e / SN, n0 + e % SN + 3, v.w);
    }
  }
  if (split) cluster_finish<Acc, SN>(part, MR * SN, a, scale, 0, n0);
}

// ---------------------------------------------- tiled path, emulate

// Elements col .. col+3 of row `row` of a row-major [rows, ld] matrix as
// f32, zero past `rows` and ld.  vec: rows are whole 16-byte pieces, so a
// 4-element piece (16 bytes f32, 8 bf16) is wholly inside or outside.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int row, int rows,
                                        int col, int ld, bool vec) {
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (row < rows && col < ld) {
    const T* src = p + (size_t)row * ld + col;
    if (vec) {
      if constexpr (sizeof(T) == 4) {
        return *reinterpret_cast<const float4*>(src);
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
        const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = to_f(h[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < ld) v[e] = to_f(src[e]);
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 kq4(float4 v, const Bits& b) {
  return make_float4(kq(v.x, b), kq(v.y, b), kq(v.z, b), kq(v.w, b));
}

// 16 x 16 threads, thread (ty, tx) owning rows ty*4 + 0..3 and columns
// tx*4 + 0..3 of a 64x64 tile: per k, one 16-byte shared load of X (the
// tile is k-major) and one of W feed 16 FMAs.  The next k tile is loaded
// into registers while this one is multiplied, then rounded by kq_a /
// kq_w as it is staged.
template <typename TW>
__global__ void __launch_bounds__(THREADS_F, 4)
fxp_emulate_tiled_kernel(Args a) {
  __shared__ __align__(16) struct {
    float x[2][BK_F][XP];       // [buffer][k][m]
    float w[2][BK_F][TILE];     // [buffer][k][n]
    float inbox[TILE * TILE];   // a K split's partials (peers push here)
  } sm;
  const TW* w = static_cast<const TW*>(a.w);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  int t0;
  const int nk = split_range(a, BK_F, &t0) - t0;
  if (gridDim.z > 1) cluster_start();
  // loader: X row tid/4, k (tid%4)*4 .. +3; W k-row tid/16, columns
  // (tid%16)*4 .. +3
  const int lm = tid / 4, lk = (tid % 4) * 4, lkw = tid / 16, lc = tx * 4;
  float4 xr, wr;
  auto fetch = [&](int kt) {
    const int k0 = (t0 + kt) * BK_F;
    xr = a.x_bf16 ? load4(static_cast<const __nv_bfloat16*>(a.x), m0 + lm,
                          a.M, k0 + lk, a.K, a.vx)
                  : load4(static_cast<const float*>(a.x), m0 + lm, a.M,
                          k0 + lk, a.K, a.vx);
    wr = load4(w, k0 + lkw, a.K, n0 + lc, a.N, a.vw);
  };
  auto put = [&](int buf) {
    const float4 xq = kq4(xr, a.bx);
    sm.x[buf][lk + 0][lm] = xq.x;
    sm.x[buf][lk + 1][lm] = xq.y;
    sm.x[buf][lk + 2][lm] = xq.z;
    sm.x[buf][lk + 3][lm] = xq.w;
    *reinterpret_cast<float4*>(&sm.w[buf][lkw][lc]) = kq4(wr, a.bw);
  };
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  if (nk > 0) {
    fetch(0);
    put(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kt + 1);
    const int buf = kt & 1;
#pragma unroll
    for (int k = 0; k < BK_F; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.x[buf][k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.w[buf][k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    if (kt + 1 < nk) put(buf ^ 1);   // read last in step kt - 1
    __syncthreads();
  }

  if (gridDim.z > 1) {
    cluster_ready();
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cluster_push<float, 4>(
          sm.inbox, TILE * TILE, (ty * 4 + r) * TILE + tx * 4,
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    cluster_finish<float, TILE>(sm.inbox, TILE * TILE, a, 1.0f, m0, n0);
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store_out(a, 1.0f, m0 + ty * 4 + r, n0 + tx * 4 + c, acc[r][c]);
}

// ------------------------------------------------- tiled path, int8

// A 4-row x 16-column block of a row-major [rows, ld] int8 matrix at
// (row, col), as 4 rows of 4 little-endian words; zero past `rows` and ld.
// vec: ld % 16 == 0 and the base 16-byte aligned (one 16-byte load a row).
__device__ __forceinline__ void load_block(unsigned (&r)[4][4],
                                           const int8_t* p, int row, int rows,
                                           int col, int ld, bool vec) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rr = row + j;
    r[j][0] = r[j][1] = r[j][2] = r[j][3] = 0u;
    if (rr >= rows || col >= ld) continue;
    const int8_t* src = p + (size_t)rr * ld + col;
    if (vec) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      r[j][0] = v.x; r[j][1] = v.y; r[j][2] = v.z; r[j][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (col + e < ld)
          r[j][e / 4] |= (unsigned)(uint8_t)src[e] << (8 * (e % 4));
    }
  }
}

// The block's 4 rows as they are: dst[j * LDT + 0..15] (X: k is the row).
__device__ __forceinline__ void put_rows(const unsigned (&r)[4][4],
                                         int8_t* dst) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint4*>(dst + j * LDT) =
        make_uint4(r[j][0], r[j][1], r[j][2], r[j][3]);
}

// The block's 4x4 byte squares transposed: 16 column rows of 4 k-values,
// dst[c * LDT + 0..3], c = 0..15 (W: [n][k]).
__device__ __forceinline__ void put_block(const unsigned (&r)[4][4],
                                          int8_t* dst) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned t0 = __byte_perm(r[0][q], r[1][q], 0x5140);
    const unsigned t1 = __byte_perm(r[2][q], r[3][q], 0x5140);
    const unsigned t2 = __byte_perm(r[0][q], r[1][q], 0x7362);
    const unsigned t3 = __byte_perm(r[2][q], r[3][q], 0x7362);
    *reinterpret_cast<unsigned*>(dst + (4 * q + 0) * LDT) =
        __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<unsigned*>(dst + (4 * q + 1) * LDT) =
        __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<unsigned*>(dst + (4 * q + 2) * LDT) =
        __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<unsigned*>(dst + (4 * q + 3) * LDT) =
        __byte_perm(t2, t3, 0x7632);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS_I) fxp_int8_tiled_kernel(Args a) {
  // [buffer][m][k] of X and [buffer][n][k] of W; after the k loop, a
  // split's partial [TILE][TILE] int32
  __shared__ __align__(16) struct {
    int8_t x[2][TILE * LDT], w[2][TILE * LDT];
    int inbox[TILE * TILE];     // a K split's partials (peers push here)
  } sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  int t0;
  const int nk = split_range(a, BK_I, &t0) - t0;
  if (gridDim.z > 1) cluster_start();

  // loader: threads 0-63 take X's 64 blocks (4 rows x 16 k), 64-127 W's
  // (4 k x 16 columns, transposed as they are staged)
  const bool is_x = tid < 64;
  const int blk = tid % 64, q = blk % 16, cb = blk / 16;
  const int8_t* src = static_cast<const int8_t*>(is_x ? a.x : a.w);
  unsigned ra[4][4], rb[4][4];   // two k tiles in flight: even, odd
  auto fetch = [&](unsigned (&r)[4][4], int kt) {
    if (kt >= nk) return;
    const int k0 = (t0 + kt) * BK_I;
    if (is_x)
      load_block(r, src, m0 + q * 4, a.M, k0 + cb * 16, a.K, a.vx);
    else
      load_block(r, src, k0 + q * 4, a.K, n0 + cb * 16, a.N, a.vw);
  };
  auto put = [&](const unsigned (&r)[4][4], int buf) {
    if (is_x)
      put_rows(r, sm.x[buf] + q * 4 * LDT + cb * 16);
    else
      put_block(r, sm.w[buf] + cb * 16 * LDT + q * 4);
  };

  // compute: warp (wm, wn) owns rows wm*32.., columns wn*32..; C fragment:
  // e = 0,1 at row gq, e = 2,3 at row gq + 8, column tg*2 + e%2
  const int wm = warp / 2, wn = warp % 2, gq = lane / 4, tg = lane % 4;
  auto out_row = [&](int mi, int e) {
    return wm * 32 + mi * 16 + gq + (e / 2) * 8;
  };
  auto out_col = [&](int ni, int e) {
    return wn * 32 + ni * 8 + tg * 2 + e % 2;
  };
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  auto mma_tile = [&](int buf) {
#pragma unroll
    for (int ks = 0; ks < BK_I / 32; ++ks) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p =
            sm.x[buf] + (wm * 32 + mi * 16 + gq) * LDT + ks * 32 + tg * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDT);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDT + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p =
            sm.w[buf] + (wn * 32 + ni * 8 + gq) * LDT + ks * 32 + tg * 4;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(p);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  };

  // tile kt is staged in buffer kt & 1; while the tensor cores work on it,
  // the next is staged from registers and the one after is loaded
  fetch(ra, 0);
  fetch(rb, 1);
  const float scale = a.raw ? 1.0f : a.scale[0];   // int32: no scale
  if (nk > 0) put(ra, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; kt += 2) {
    fetch(ra, kt + 2);
    mma_tile(0);
    if (kt + 1 < nk) put(rb, 1);           // buffer 1 is free
    __syncthreads();
    if (kt + 1 >= nk) break;
    fetch(rb, kt + 3);
    mma_tile(1);
    if (kt + 2 < nk) put(ra, 0);           // buffer 0 is free
    __syncthreads();
  }

  if (gridDim.z > 1) {
    cluster_ready();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          cluster_push<int, 2>(
              sm.inbox, TILE * TILE, out_row(mi, e) * TILE + out_col(ni, e),
              make_int2(acc[mi][ni][e], acc[mi][ni][e + 1]));
    cluster_finish<int, TILE>(sm.inbox, TILE * TILE, a, scale, m0, n0);
    return;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_out(a, scale, m0 + out_row(mi, e), n0 + out_col(ni, e),
                  acc[mi][ni][e]);
}

// ---------------------------------------------------------------- launch

// One launch of `kern` over `grid`; with grid.z = S > 1 the S CTAs of an
// output tile form one cluster (1 x 1 x S), more than 8 a non-portable size.
template <typename Kern>
int launch(Kern kern, dim3 grid, int threads, int smem, cudaStream_t stream,
           const Args& a) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess && grid.z > 8)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The split plan must be a power of two S <= MAX_SPLITS, at most one split
// a tile (no empty split), S = 1 when there is no tile.
bool splits_ok(int K, int bk, int S) {
  const int nt = (K + bk - 1) / bk;
  if (S < 1 || S > MAX_SPLITS || (S & (S - 1)) != 0) return false;
  return nt == 0 ? S == 1 : S <= nt;
}

dim3 tiled_grid(const Args& a) {
  return dim3((a.N + TILE - 1) / TILE, (a.M + TILE - 1) / TILE, a.S);
}

template <typename TW, int MR>
int launch_decode(const Args& a, cudaStream_t stream) {
  using D = Dec<TW>;
  using L = DecSmem<TW, MR>;
  if (!splits_ok(a.K, D::BKR, a.S)) return (int)cudaErrorInvalidValue;
  const int nt = (a.K + D::BKR - 1) / D::BKR;
  const int xrows = (nt + a.S - 1) / a.S * D::BKR;
  const int xe = L::I8 ? 1 : a.x_bf16 ? 2 : 4;
  if (L::x_bytes(xrows, xe) > X_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.N + SN - 1) / SN, 1, a.S);
  return launch(fxp_decode_kernel<TW, MR>, grid, THREADS_D,
                L::total(xrows, xe), stream, a);
}

template <typename TW>
int launch_emulate(const Args& a, int path, cudaStream_t stream) {
  if (path == 0)
    return a.M <= 8 ? launch_decode<TW, 8>(a, stream)
                    : launch_decode<TW, 16>(a, stream);
  if (!splits_ok(a.K, BK_F, a.S)) return (int)cudaErrorInvalidValue;
  return launch(fxp_emulate_tiled_kernel<TW>, tiled_grid(a), THREADS_F, 0,
                stream, a);
}

Args make_args(const void* x, const void* w, const float* scale, float* y,
               int M, int N, int K, int S, int vx, int vw) {
  Args a = {};
  a.x = x; a.w = w; a.scale = scale; a.y = y;
  a.M = M; a.N = N; a.K = K; a.S = S; a.vx = vx; a.vw = vw;
  a.bx = a.bw = a.bo = make_bits(0, 0, 0);
  return a;
}

}  // namespace

// path: 0 = the decode path (M <= 16), 1 = tiles for large M.  S: K splits
// (a power of two <= 16, at most one a K tile).  vx / vw: 1 when the rows
// of X / W are whole 16-byte pieces from a 16-byte aligned base.
extern "C" int fxp_matmul_emulate(const void* x, const void* w, float* y,
                                  int M, int N, int K, int x_bf16, int w_bf16,
                                  int xa_on, int xa_i, int xa_f, int w_on,
                                  int w_i, int w_f, int o_on, int o_i, int o_f,
                                  int act, int path, int S, int vx, int vw,
                                  cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (path == 0 ? M > 16 : path != 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(x, w, nullptr, y, M, N, K, S, vx, vw);
  a.bx = make_bits(xa_on, xa_i, xa_f);
  a.bw = make_bits(w_on, w_i, w_f);
  a.bo = make_bits(o_on, o_i, o_f);
  a.act = act;
  a.x_bf16 = x_bf16;
  return w_bf16 ? launch_emulate<__nv_bfloat16>(a, path, stream)
                : launch_emulate<float>(a, path, stream);
}

// raw: 1 stores the int32 sums into y (int32 [M, N]; then o_on and act
// must be 0, and scale is not read: it may be null).
extern "C" int fxp_matmul_int8(const void* x, const void* w,
                               const float* scale, float* y, int M, int N,
                               int K, int o_on, int o_i, int o_f, int act,
                               int path, int S, int vx, int vw, int raw,
                               cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (path == 0 ? M > 16 : path != 1) return (int)cudaErrorInvalidValue;
  if (raw && (o_on || act != 0)) return (int)cudaErrorInvalidValue;
  if (!raw && scale == nullptr) return (int)cudaErrorInvalidValue;
  Args a = make_args(x, w, scale, y, M, N, K, S, vx, vw);
  a.bo = make_bits(o_on, o_i, o_f);
  a.act = act;
  a.raw = raw;
  if (path == 0)
    return M <= 8 ? launch_decode<int8_t, 8>(a, stream)
                  : launch_decode<int8_t, 16>(a, stream);
  if (!splits_ok(K, BK_I, S)) return (int)cudaErrorInvalidValue;
  return launch(fxp_int8_tiled_kernel, tiled_grid(a), THREADS_I, 0, stream,
                a);
}
