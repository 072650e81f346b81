// bp_gstep: the G-chain step of split SGD, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bp_gstep.py::bp_gstep, the Pallas TPU kernel
// bodies _kernel (emulate) and _kernel_int8 (int8 MXU datapath).
//
//   emulate: G_i = kq_g((G @ Wᵀ) ⊙ f'(Z))                 G, W, Z f32
//   int8:    G_i = kq_g((scale · int32(qG @ qWᵀ)) ⊙ f'(Z)) exact int32 sums
//
// with G [T, Dout], W [Din, Dout] (forward orientation), Z [T, Din] or
// absent (then f' is 1: the dense unit's dx = dz @ Wᵀ), out [T, Din] f32.
//
// What bounds it on this card depends on the contraction's length, Dout:
// * Long (the dense engine's dx, qwen1.5-0.5b's MLP: T 2048, Dout 1024 or
//   2816): 2·T·Din·Dout = 11.8 G operations on 10-51 MB.  f32 is bound by
//   its operations on the CUDA cores (0.176 ms at 67 TFLOP/s), int8 by its
//   operations on the tensor cores (6 us at 1979 TOP/s) or by the bytes of
//   the f32 output and Z (8-15 us).
// * Short (the LeNet head: Dout 10): 10 multiply-adds an output, so it is
//   bound by the bytes of Z and of the output ([T, Din] f32 each), and at
//   T 128-1024 (128 KB-1 MB each) by the latency of one pass through
//   device memory and by how many SMs have work.
//
// What the design does about that (kernels/bp_gstep.py::_plan picks the
// path from the shapes alone; one launch a call):
// * Tiled path (Dout >= 16).  A CTA of 8 warps owns a 128x128 output tile.
//   G [T, Dout] and W [Din, Dout] are both contiguous along the
//   contraction, so their tiles are staged as they are, in rows padded by
//   16 bytes (which makes ldmatrix and the 16-byte shared loads free of
//   bank conflicts), through a ring of 16-byte cp.async copies (Ring).
//   int8 (64-byte tiles, four stages, two CTAs an SM) runs mma.sync
//   m16n8k32 s8·s8->s32 with both operands read by ldmatrix.x4 as they
//   were staged: G is the row-major A and W the column-major B that the
//   instruction wants, so nothing is transposed (64x32 outputs a warp, 64
//   int32 accumulators a thread).  f32 (128-byte tiles, three stages, one
//   CTA an SM with up to 255 registers a thread: two CTAs of 128 spilled
//   and ran slower) runs 8x8 register tiles: a thread owns rows
//   r0 + 4i and columns c0 + 8j of its warp's 32x64 block, and for 4 k one
//   16-byte load of each of its 8 G rows and 8 W rows feeds 256 FMAs; a
//   warp's rows (and columns) are neighbours, so each load is one
//   conflict-free wavefront.  No TF32: f32 sums stay f32 sums.  Where the
//   tiles cannot fill the card (a LeNet hidden layer's dx, T 128 x 256 x
//   256, has 2), Dout is split into S tile-aligned ranges, S a power of two
//   <= 8: the S CTAs of a tile form a thread-block cluster, each puts its
//   partial tile (int32 for int8) in its own shared memory, and after one
//   cluster barrier each sums its 1/S of the rows over the S tiles in rank
//   order, through distributed shared memory, before the epilogue; one
//   launch, no scratch, int8 still exact.
// * Short path (Dout < 16).  A CTA of 4, 8 or 16 rows x 64 columns stages
//   its G rows and its 64 W rows (Dout values each) once, a thread a k
//   value of a row, so no index divides by Dout, W transposed to
//   [k][column] (int8: bytes, turned into each column's 4 k by
//   __byte_perm for __dp4a); a thread computes 4 consecutive outputs of
//   one row over all 16 k (zeros past Dout), so Z and the output move as
//   one 16-byte vector a thread where the row allows, and Z's load is
//   issued first, in flight while G and W are staged.
// * Unaligned rows.  Tiled G and W rows that are no whole 16-byte pieces
//   (int8 Dout 1000, f32 Dout 70) or a base off a 16-byte boundary are
//   staged element by element (4-byte cp.async for f32, byte loads for
//   int8), masked; Z and the output fall back to element access likewise.
//   Every ragged edge is zero-filled or masked, so no dimension has to
//   divide a tile.
// * Epilogue, in the reference's order: the int8 rescale once
//   (__fmul_rn of the exact int32 sum), then the product with f'(Z), then
//   the (I,F) rounding by rintf (round half to even, like jnp.round; never
//   roundf) of x · 2^F, which is exactly x / 2^-F.  The tiled path stages
//   its rescaled tile in shared memory (the ring, free by then) so that Z
//   is read and the output written as 16-byte vectors, a warp a 512-byte
//   row.  f'(Z) is written op by op with __fadd_rn / __fmul_rn /
//   __fdiv_rn in the plain version's order, so that nvcc contracts nothing
//   into an FMA that PyTorch rounds twice, and compiled once per
//   activation (DISPATCH_ACT), so that a call runs straight-line code of
//   its own activation only (a switch per element, in the unrolled
//   epilogue, ran the silu rows far slower).  int32 sums are exact, so the
//   int8 result is bitwise the plain version's.
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// tiled path
constexpr int TM = 128;                   // output rows (tokens) a CTA
constexpr int TN = 128;                   // output columns (Din) a CTA
constexpr int THREADS_T = 256;            // 8 warps
constexpr int MAX_SPLITS = 8;             // Dout splits: a portable cluster
constexpr int OP = TN + 8;                // floats a row of the output tile

// The tiled path's ring, by datapath: KB bytes of Dout a staged tile (int8
// 64, two mma k-steps; f32 128, 32 values), rows padded by 16 bytes, STAGES
// tiles: int8 four (80 KB; two CTAs an SM), f32 three (108 KB; one CTA an
// SM, of up to 255 registers a thread).
template <bool I8>
struct Ring {
  static constexpr int KB = I8 ? 64 : 128;
  static constexpr int PITCH = KB + 16;
  static constexpr int STAGES = I8 ? 4 : 3;
  static constexpr int STAGE = (TM + TN) * PITCH;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(TM * OP * 4 <= BYTES, "the output tile reuses the ring");
};

// short path
constexpr int SC = 64;                    // output columns a CTA
constexpr int SQ = SC / 4;                // threads a row (4 outputs each)
constexpr int SROWS_MIN = 4;              // rows a CTA: 4, 8 or 16
constexpr int SROWS_MAX = 16;
constexpr int SK = 16;                    // Dout below this is short

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
  float k = fminf(fmaxf(rintf(__fmul_rn(x, b.inv)), b.qmin), b.qmax);
  return __fmul_rn(k, b.step);
}

// The derivation unit f'(z) (kernels/common.py::act_deriv), one rounding
// per PyTorch op of the plain version (a reciprocal times 1 is the
// division; python scalars are f32 there).  ACT: the activation code.
template <int ACT>
__device__ __forceinline__ float act_deriv(float z) {
  if constexpr (ACT == 1) {
    return z > 0.0f ? 1.0f : 0.0f;
  } else if constexpr (ACT == 2) {
    const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
    return __fmul_rn(s, __fsub_rn(1.0f, s));
  } else if constexpr (ACT == 3) {
    const float t = tanhf(z);
    return __fsub_rn(1.0f, __fmul_rn(t, t));
  } else if constexpr (ACT == 4) {
    const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
    return __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(z, __fsub_rn(1.0f, s))));
  } else if constexpr (ACT == 5) {
    constexpr float C = 0.7978845608028654f, A = 0.044715f;
    constexpr float A3 = (float)(3.0 * 0.044715);
    const float z3 = __fmul_rn(__fmul_rn(__fmul_rn(A, z), z), z);
    const float t = tanhf(__fmul_rn(C, __fadd_rn(z, z3)));
    const float du =
        __fmul_rn(C, __fadd_rn(1.0f, __fmul_rn(__fmul_rn(A3, z), z)));
    const float left = __fmul_rn(0.5f, __fadd_rn(1.0f, t));
    const float right = __fmul_rn(
        __fmul_rn(__fmul_rn(0.5f, z), __fsub_rn(1.0f, __fmul_rn(t, t))), du);
    return __fadd_rn(left, right);
  } else {
    return 1.0f;
  }
}

struct Args {
  const void* g;        // [T, Dout] f32 or int8
  const void* w;        // [Din, Dout] f32 or int8
  const float* scale;   // int8: s_g * s_w (device scalar)
  const float* z;       // [T, Din] f32 or null
  float* out;           // [T, Din] f32
  int T, Din, Dout;
  int vec;              // rows of G and W are whole 16-byte pieces
  int vz, vo;           // Z / out rows are float4 rows from aligned bases
  Bits bg;
  int act;
  int raw;              // int8: store the int32 sums (out is int32)
};

// Four consecutive Z values of row gm from column gn (zero where masked).
__device__ __forceinline__ float4 load_z4(const Args& a, int gm, int gn) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.z == nullptr || gm >= a.T || gn >= a.Din) return v;
  const float* p = a.z + (size_t)gm * a.Din + gn;
  if (a.vz) return *reinterpret_cast<const float4*>(p);
  v.x = p[0];
  if (gn + 1 < a.Din) v.y = p[1];
  if (gn + 2 < a.Din) v.z = p[2];
  if (gn + 3 < a.Din) v.w = p[3];
  return v;
}

// The epilogue of four consecutive outputs (already rescaled): f'(Z)
// (ACT 0: none, so Z is not read; identity's f' = 1 changes nothing),
// kq_g, and the store, masked past T and Din.
template <int ACT>
__device__ __forceinline__ void finish4(const Args& a, int gm, int gn,
                                        float4 y, float4 zv) {
  if (gm >= a.T || gn >= a.Din) return;
  if constexpr (ACT != 0) {
    y.x = __fmul_rn(y.x, act_deriv<ACT>(zv.x));
    y.y = __fmul_rn(y.y, act_deriv<ACT>(zv.y));
    y.z = __fmul_rn(y.z, act_deriv<ACT>(zv.z));
    y.w = __fmul_rn(y.w, act_deriv<ACT>(zv.w));
  }
  y = make_float4(kq(y.x, a.bg), kq(y.y, a.bg), kq(y.z, a.bg),
                  kq(y.w, a.bg));
  float* p = a.out + (size_t)gm * a.Din + gn;
  if (a.vo) {
    *reinterpret_cast<float4*>(p) = y;
    return;
  }
  p[0] = y.x;
  if (gn + 1 < a.Din) p[1] = y.y;
  if (gn + 2 < a.Din) p[2] = y.z;
  if (gn + 3 < a.Din) p[3] = y.w;
}

// The int32 mode's epilogue: four consecutive exact int32 sums stored as
// they are (no rescale, no f'(Z), no rounding), masked past T and Din.
__device__ __forceinline__ void store_raw4(const Args& a, int gm, int gn,
                                           int4 t) {
  if (gm >= a.T || gn >= a.Din) return;
  int* p = reinterpret_cast<int*>(a.out) + (size_t)gm * a.Din + gn;
  if (a.vo) {
    *reinterpret_cast<int4*>(p) = t;
    return;
  }
  p[0] = t.x;
  if (gn + 1 < a.Din) p[1] = t.y;
  if (gn + 2 < a.Din) p[2] = t.z;
  if (gn + 3 < a.Din) p[3] = t.w;
}

// The activation code that the epilogue applies: 0 without Z.
__device__ __forceinline__ int epilogue_act(const Args& a) {
  return a.z == nullptr ? 0 : a.act;
}

// F(ACT) for the runtime code: one copy of the epilogue per activation.
#define DISPATCH_ACT(code, F) \
  switch (code) {             \
    case 1: F(1); break;      \
    case 2: F(2); break;      \
    case 3: F(3); break;      \
    case 4: F(4); break;      \
    case 5: F(5); break;      \
    default: F(0); break;     \
  }

// ------------------------------------------------------------ staging

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

// Tile kt of the contraction (KB bytes of Dout) of the CTA's TM G rows and
// TN W rows into one ring stage: rows [0, TM) are G's, [TM, TM + TN) W's,
// each KB bytes at a PITCH stride; zero past T, Din and Dout.
template <bool I8>
__device__ __forceinline__ void stage_tile(unsigned char* st, const Args& a,
                                           int m0, int n0, int kt) {
  using R = Ring<I8>;
  constexpr int E = I8 ? 1 : 4;           // bytes an element
  constexpr int KE = R::KB / E;           // elements of Dout a tile
  const int k0 = kt * KE;
  const unsigned char* gb = static_cast<const unsigned char*>(a.g);
  const unsigned char* wb = static_cast<const unsigned char*>(a.w);
  if (a.vec) {
    // KB / 16 pieces of 16 bytes a row, neighbouring threads on one row; a
    // warp's 32 pieces lie in one operand
    constexpr int PIECES = R::KB / 16;
    static_assert(TM * PIECES % 32 == 0, "a warp stages one operand");
#pragma unroll
    for (int i = 0; i < (TM + TN) * PIECES / THREADS_T; ++i) {
      const int c = i * THREADS_T + (int)threadIdx.x;
      const int r = c / PIECES, q = c % PIECES;
      const bool is_g = r < TM;
      const int gr = is_g ? m0 + r : n0 + r - TM;
      const int gk = k0 + q * (16 / E);
      const unsigned char* base = is_g ? gb : wb;
      const bool ok = gr < (is_g ? a.T : a.Din) && gk < a.Dout;
      cp16(st + r * R::PITCH + q * 16,
           ok ? base + ((size_t)gr * a.Dout + gk) * E : base, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < (TM + TN) * KE; c += THREADS_T) {
      const int r = c / KE, kk = c % KE;
      const bool is_g = r < TM;
      const int gr = is_g ? m0 + r : n0 + r - TM;
      const int gk = k0 + kk;
      const unsigned char* base = is_g ? gb : wb;
      const bool ok = gr < (is_g ? a.T : a.Din) && gk < a.Dout;
      const unsigned char* src = base + ((size_t)gr * a.Dout + gk) * E;
      unsigned char* dst = st + r * R::PITCH + kk * E;
      if constexpr (I8)
        *dst = ok ? *src : (unsigned char)0;
      else
        cp4(dst, ok ? src : base, ok ? 4 : 0);
    }
  }
}

// ------------------------------------------------------- tiled, compute

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8: warp (wm, wn) = (warp / 4, warp % 4) owns rows wm*64 + [0, 64) and
// columns wn*32 + [0, 32): 4 x 4 m16n8 blocks.  ldmatrix.x4 gives an A
// fragment (rows 0-15 x k 0-31 of a block) from lanes addressing rows
// lane % 16 at k (lane / 16) * 16, and two B fragments (columns 0-15 x
// k 0-31) from lanes addressing columns (lane % 8) + (lane / 16) * 8 at k
// ((lane / 8) % 2) * 16.
struct Int8Tile {
  using R = Ring<true>;
  int acc[4][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  }
  __device__ __forceinline__ void step(const unsigned char* st, int warp,
                                       int lane) {
    const int wm = warp >> 2, wn = warp & 3;
    const unsigned char* pa =
        st + (wm * 64 + (lane & 15)) * R::PITCH + (lane >> 4) * 16;
    const unsigned char* pb =
        st + (TM + wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * R::PITCH +
        ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int ks = 0; ks < R::KB / 32; ++ks) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], pa + mi * 16 * R::PITCH + ks * 32);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        ldsm_x4(r, pb + nj * 16 * R::PITCH + ks * 32);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  // C fragment: e = 0, 1 at row gq, e = 2, 3 at row gq + 8, columns
  // 2 tg + e % 2; the int32 sums into the output tile (rescaled when the
  // splits are summed)
  __device__ __forceinline__ void store(void* ot, int warp, int lane) const {
    const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 64 + mi * 16 + gq + 8 * h;
          const int c = wn * 32 + ni * 8 + 2 * tg;
          *reinterpret_cast<int2*>(static_cast<int*>(ot) + r * OP + c) =
              make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
  }
};

// emulate: warp (wm, wn) = (warp / 2, warp % 2) owns rows wm*32 + [0, 32)
// and columns wn*64 + [0, 64); lane (tm, tn) = (lane / 8, lane % 8) owns
// rows wm*32 + tm + 4i and columns wn*64 + tn + 8j, i, j < 8.
struct F32Tile {
  using R = Ring<false>;
  float acc[8][8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  __device__ __forceinline__ void step(const unsigned char* st, int warp,
                                       int lane) {
    const int wm = warp >> 1, wn = warp & 1, tm = lane >> 3, tn = lane & 7;
    const unsigned char* pa = st + (wm * 32 + tm) * R::PITCH;
    const unsigned char* pb = st + (TM + wn * 64 + tn) * R::PITCH;
#pragma unroll
    for (int q = 0; q < R::KB / 16; ++q) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(pa + 4 * i * R::PITCH +
                                                 q * 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(pb + 8 * j * R::PITCH + q * 16);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float s = acc[i][j];
          s = fmaf(av[i].x, bv.x, s);
          s = fmaf(av[i].y, bv.y, s);
          s = fmaf(av[i].z, bv.z, s);
          s = fmaf(av[i].w, bv.w, s);
          acc[i][j] = s;
        }
      }
    }
  }
  __device__ __forceinline__ void store(void* ot, int warp, int lane) const {
    const int wm = warp >> 1, wn = warp & 1, tm = lane >> 3, tn = lane & 7;
    float* o = static_cast<float*>(ot);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[(wm * 32 + tm + 4 * i) * OP + wn * 64 + tn + 8 * j] = acc[i][j];
  }
};

// The CTA's share of the output tile through f'(Z), kq_g and the stores:
// a warp a row of 32 float4 pieces, Z read 8 pieces ahead.  SPLIT: the
// share is rows [r0, r0 + TM / S) of split (cluster rank) r0 / (TM / S) of
// S, summed over the S partial tiles of the cluster (each in its CTA's
// shared memory) in rank order -- int8 as int32, then one rescale;
// otherwise the whole tile, S = 1, every count a constant.
template <int ACT, bool I8, bool SPLIT>
__device__ __forceinline__ void finish_tile(const Args& a, float* ot,
                                            int m0, int n0) {
  const int S = SPLIT ? (int)gridDim.z : 1, rows = TM / S;
  const int r0 = SPLIT ? (int)blockIdx.z * rows : 0;
  const int pieces = rows * (TN / 4);
  auto part = [&](int s) -> const float* {
    if constexpr (SPLIT) return cg::this_cluster().map_shared_rank(ot, s);
    return ot;
  };
  const float scale = I8 && !a.raw ? a.scale[0] : 1.0f;
  constexpr int BATCH = 8;
  const int tid = threadIdx.x;
  for (int b = 0; b < pieces; b += BATCH * THREADS_T) {
    float4 zv[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = b + i * THREADS_T + tid;
      zv[i] = ACT != 0 && c < pieces
                  ? load_z4(a, m0 + r0 + (c >> 5), n0 + 4 * (c & 31))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = b + i * THREADS_T + tid;
      if (c >= pieces) break;
      const int off = (r0 + (c >> 5)) * OP + 4 * (c & 31);
      float4 y;
      if constexpr (I8) {
        int4 t = *reinterpret_cast<const int4*>(part(0) + off);
        for (int s = 1; s < S; ++s) {
          const int4 p = *reinterpret_cast<const int4*>(part(s) + off);
          t.x += p.x; t.y += p.y; t.z += p.z; t.w += p.w;
        }
        if (a.raw) {
          store_raw4(a, m0 + r0 + (c >> 5), n0 + 4 * (c & 31), t);
          continue;
        }
        y = make_float4(__fmul_rn((float)t.x, scale),
                        __fmul_rn((float)t.y, scale),
                        __fmul_rn((float)t.z, scale),
                        __fmul_rn((float)t.w, scale));
      } else {
        y = *reinterpret_cast<const float4*>(part(0) + off);
        for (int s = 1; s < S; ++s) {
          const float4 p = *reinterpret_cast<const float4*>(part(s) + off);
          y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
        }
      }
      finish4<ACT>(a, m0 + r0 + (c >> 5), n0 + 4 * (c & 31), y, zv[i]);
    }
  }
}

template <bool I8>
__global__ void __launch_bounds__(THREADS_T, I8 ? 2 : 1)
gstep_tiled_kernel(Args a) {
  using Tile = typename std::conditional<I8, Int8Tile, F32Tile>::type;
  using R = Ring<I8>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  // this split's Dout tiles: [t0, t0 + nk) of ceil(Dout / KE), the
  // balanced partition into S = gridDim.z ranges (the wrapper's plan)
  constexpr int KE = I8 ? R::KB : R::KB / 4;
  const int nt = (a.Dout + KE - 1) / KE, S = gridDim.z;
  const int t0 = (int)blockIdx.z * nt / S;
  const int nk = ((int)blockIdx.z + 1) * nt / S - t0;

#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < nk) stage_tile<I8>(smem + s * R::STAGE, a, m0, n0, t0 + s);
    cp_commit();
  }
  Tile tile;
  tile.zero();
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<R::STAGES - 2>();
    __syncthreads();            // tile kt landed; tile kt - 1's stage free
    const int nx = kt + R::STAGES - 1;
    if (nx < nk) stage_tile<I8>(smem + (nx % R::STAGES) * R::STAGE, a, m0,
                                n0, t0 + nx);
    cp_commit();
    tile.step(smem + (kt % R::STAGES) * R::STAGE, warp, lane);
  }
  cp_wait<0>();
  __syncthreads();              // the ring is free: the output tile
  float* ot = reinterpret_cast<float*>(smem);
  tile.store(ot, warp, lane);
  if (S > 1)
    cg::this_cluster().sync();  // every split's partial tile is in place
  else
    __syncthreads();
#define TILE_EPILOGUE(ACT) finish_tile<ACT, I8, false>(a, ot, m0, n0)
#define SPLIT_EPILOGUE(ACT) finish_tile<ACT, I8, true>(a, ot, m0, n0)
  if (S > 1) {
    DISPATCH_ACT(epilogue_act(a), SPLIT_EPILOGUE)
    cg::this_cluster().sync();  // peers are done reading this tile
  } else {
    DISPATCH_ACT(epilogue_act(a), TILE_EPILOGUE)
  }
#undef SPLIT_EPILOGUE
#undef TILE_EPILOGUE
}

// ------------------------------------------------------------ short path

template <bool I8>
__global__ void __launch_bounds__(SQ * SROWS_MAX) gstep_short_kernel(Args a) {
  using V = typename std::conditional<I8, int8_t, float>::type;
  static_assert(SK == SQ, "a thread a k value of a row when staging");
  __shared__ __align__(16) V ws[SK][SC + 4];    // W^T: [k][column]
  __shared__ __align__(16) V gs[SROWS_MAX][SK]; // G: [row][k]
  const int tid = threadIdx.x, rows = blockDim.x / SQ;
  const int r = tid / SQ, q = tid % SQ;
  const int m0 = blockIdx.x * rows, n0 = blockIdx.y * SC;
  const int gm = m0 + r, gn = n0 + 4 * q;
  // Z first: in flight while G and W are staged
  const float4 zv = load_z4(a, gm, gn);

  // W rows n0 .. n0 + SC - 1 and G rows m0 .. m0 + rows - 1 (Dout values
  // each, contiguous, zero past Dout): thread (k, row) = (tid % SK,
  // tid / SK), a W row every `rows` rows, so that no index divides by
  // Dout; every load of a thread is issued before its first store
  const V* wp = static_cast<const V*>(a.w);
  const V* gp = static_cast<const V*>(a.g);
  const int k = tid % SK;
  constexpr int PER = SC / SROWS_MIN;           // W rows a thread, at most
  V wt[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = r + i * rows;
    wt[i] = k < a.Dout && n < SC && n0 + n < a.Din
                ? wp[(size_t)(n0 + n) * a.Dout + k] : V(0);
  }
  const V gt = k < a.Dout && gm < a.T ? gp[(size_t)gm * a.Dout + k] : V(0);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = r + i * rows;
    if (n < SC) ws[k][n] = wt[i];
  }
  gs[r][k] = gt;
  __syncthreads();

  // all SK k of the tiles, unrolled: the zeros past Dout add nothing
  float4 y;
  if constexpr (I8) {
    // 4 k a step: the 4x4 byte square of k-rows 4j .. 4j+3 x this thread's
    // columns, transposed with __byte_perm into each column's 4 k, against
    // the row's 4 k of G, by __dp4a: exact int32 sums
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < SK / 4; ++j) {
      const unsigned r0 = *reinterpret_cast<const unsigned*>(&ws[4 * j][4 * q]);
      const unsigned r1 =
          *reinterpret_cast<const unsigned*>(&ws[4 * j + 1][4 * q]);
      const unsigned r2 =
          *reinterpret_cast<const unsigned*>(&ws[4 * j + 2][4 * q]);
      const unsigned r3 =
          *reinterpret_cast<const unsigned*>(&ws[4 * j + 3][4 * q]);
      const unsigned u0 = __byte_perm(r0, r1, 0x5140);
      const unsigned u1 = __byte_perm(r2, r3, 0x5140);
      const unsigned u2 = __byte_perm(r0, r1, 0x7362);
      const unsigned u3 = __byte_perm(r2, r3, 0x7362);
      const int gw = *reinterpret_cast<const int*>(&gs[r][4 * j]);
      acc[0] = __dp4a(gw, (int)__byte_perm(u0, u1, 0x5410), acc[0]);
      acc[1] = __dp4a(gw, (int)__byte_perm(u0, u1, 0x7632), acc[1]);
      acc[2] = __dp4a(gw, (int)__byte_perm(u2, u3, 0x5410), acc[2]);
      acc[3] = __dp4a(gw, (int)__byte_perm(u2, u3, 0x7632), acc[3]);
    }
    if (a.raw) {
      store_raw4(a, gm, gn, make_int4(acc[0], acc[1], acc[2], acc[3]));
      return;
    }
    const float s = a.scale[0];
    y = make_float4(__fmul_rn((float)acc[0], s), __fmul_rn((float)acc[1], s),
                    __fmul_rn((float)acc[2], s), __fmul_rn((float)acc[3], s));
  } else {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      const float gv = gs[r][kk];
      const float4 w4 = *reinterpret_cast<const float4*>(&ws[kk][4 * q]);
      acc[0] = fmaf(gv, w4.x, acc[0]);
      acc[1] = fmaf(gv, w4.y, acc[1]);
      acc[2] = fmaf(gv, w4.z, acc[2]);
      acc[3] = fmaf(gv, w4.w, acc[3]);
    }
    y = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
#define SHORT_EPILOGUE(ACT) finish4<ACT>(a, gm, gn, y, zv)
  DISPATCH_ACT(epilogue_act(a), SHORT_EPILOGUE)
#undef SHORT_EPILOGUE
}

// ---------------------------------------------------------------- launch

// path: 0 = short (Dout < SK; rows 4, 8 or 16 a CTA), 1 = tiled (rows =
// TM; S Dout splits, a power of two <= MAX_SPLITS and at most one a Dout
// tile, whose CTAs form one cluster).  vec: 1 when the rows of G and W are
// whole 16-byte pieces from 16-byte aligned bases.
template <bool I8>
int launch(Args a, int path, int rows, int S, cudaStream_t stream) {
  a.vz = a.z == nullptr ||
         (a.Din % 4 == 0 && ((uintptr_t)a.z & 15) == 0);
  a.vo = a.Din % 4 == 0 && ((uintptr_t)a.out & 15) == 0;
  if (path == 0) {
    if ((rows != 4 && rows != 8 && rows != 16) || a.Dout >= SK || S != 1)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((a.T + rows - 1) / rows, (a.Din + SC - 1) / SC);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    gstep_short_kernel<I8><<<grid, rows * SQ, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  constexpr int KE = I8 ? Ring<I8>::KB : Ring<I8>::KB / 4;
  const int nt = (a.Dout + KE - 1) / KE;
  if (path != 1 || rows != TM || S < 1 || S > MAX_SPLITS || (S & (S - 1)) ||
      S > nt)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.T + TM - 1) / TM, (a.Din + TN - 1) / TN, S);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gstep_tiled_kernel<I8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<I8>::BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS_T);
  cfg.dynamicSmemBytes = Ring<I8>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, gstep_tiled_kernel<I8>, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

Args make_args(const void* g, const void* w, const float* scale,
               const float* z, float* out, int T, int Din, int Dout, int vec,
               int g_on, int g_i, int g_f, int act) {
  Args a = {};
  a.g = g; a.w = w; a.scale = scale; a.z = z; a.out = out;
  a.T = T; a.Din = Din; a.Dout = Dout; a.vec = vec;
  a.bg = make_bits(g_on, g_i, g_f);
  a.act = act;
  return a;
}

}  // namespace

extern "C" int bp_gstep_emulate(const float* g, const float* w,
                                const float* z, float* out, int T, int Din,
                                int Dout, int g_on, int g_i, int g_f, int act,
                                int path, int rows, int S, int vec,
                                cudaStream_t stream) {
  if (T <= 0 || Din <= 0) return 0;
  return launch<false>(make_args(g, w, nullptr, z, out, T, Din, Dout, vec,
                                 g_on, g_i, g_f, act),
                       path, rows, S, stream);
}

// raw: 1 stores the int32 sums into out (int32 [T, Din]; then z must be
// null and g_on 0, and scale is not read: it may be null).
extern "C" int bp_gstep_int8(const void* g, const void* w, const float* scale,
                             const float* z, float* out, int T, int Din,
                             int Dout, int g_on, int g_i, int g_f, int act,
                             int path, int rows, int S, int vec, int raw,
                             cudaStream_t stream) {
  if (T <= 0 || Din <= 0) return 0;
  if (raw && (z != nullptr || g_on)) return (int)cudaErrorInvalidValue;
  if (!raw && scale == nullptr) return (int)cudaErrorInvalidValue;
  Args a = make_args(g, w, scale, z, out, T, Din, Dout, vec, g_on, g_i, g_f,
                     act);
  a.raw = raw;
  return launch<true>(a, path, rows, S, stream);
}
