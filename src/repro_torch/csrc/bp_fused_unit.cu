// bp_fused_unit: the paper's whole TDM frame in one pass, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/bp_fused_unit.py::bp_fused_unit, the Pallas
// TPU kernel bodies _kernel (emulate) and _kernel_int8 (int8 MXU datapath).
// Per hidden layer, with G [T, Dout], W [Din, Dout] (f32 master), X and
// Z [T, Din]:
//
//   G_out = kq_g((G @ q_w(W)ᵀ) ⊙ f'(Z))          (Eq. 8)  -> [T, Din]
//   dW    = XᵀG                                  (Eq. 9)
//   W_new = kq_w'(W − lr · dW)                   (Eq. 1)  -> [Din, Dout]
//
//   emulate: G, X, Z f32; q_w = kq on the (I,F) grid; f32 multiply-adds.
//   int8:    G, X int8 payloads (scales s_g, s_x); W quantized to int8 in
//            the kernel, on its (I,F) grid when that embeds in 8 bits, else
//            by the absmax of the WHOLE W; exact int32 sums; the products
//            rescaled once by s_g·s_w (Eq. 8) and s_x·s_g (Eq. 9).
//
// What bounds it on this card: at the LeNet hidden layer (T = 128,
// Din = Dout = 256) the frame does 2 · 2·T·Din·Dout = 33.6 M operations on
// 0.85 MB (int8) to 1.05 MB (f32) of operands and results: in f32 on the
// CUDA cores it is bound by
// its operations (0.5 us at 67 TFLOP/s), in int8 by its bytes (0.25 us).
// Both are far below the latency of one pass through device memory, so
// what bounds it in practice is how many SMs have work and how few
// dependent steps each CTA takes.  The TPU kernel kept all of W and the dW
// accumulator resident for the whole frame, which no SM can (256x256 is
// 256 KiB of f32 W plus 256 KiB of dW against 227 KiB of shared memory),
// and any design that holds whole W rows in a CTA caps Dout.
//
// What the design does about that:
// * Tiles over both axes.  A CTA owns a 16 x 32 block of W (Din rows x
//   Dout columns: 128 CTAs at 256x256; 32-row tiles were slower at every
//   shape measured).  Its dW stays in registers for the whole token loop
//   and its W values too, read once at the start for q_w and kept for the
//   update, so dW never reaches device memory and no Dout is too wide.
// * Eq. 8 over a Dout slice, summed across slices in a fixed order.  Each
//   CTA's G_out is a partial sum over its 32 Dout columns.  The C CTAs of
//   one Din tile that hold neighbouring slices (C <= 8, the portable
//   cluster size) form a thread-block cluster: after each 64-token block a
//   CTA pushes the r-th 1/C of its partial block into CTA r's shared
//   memory (distributed shared memory) at the slot of its own rank, and
//   after one cluster barrier CTA r sums the slots in slot order and only
//   then applies f'(Z) and kq_g.  The barrier is waited for just before the
//   next push, so the next block's products run while the slowest peer
//   catches up, and the inbox has three buffers, so that the sum and its
//   G_out stores may follow the arrival (a release orders every store
//   before it) and no second barrier is needed.  Where Dout needs more
//   slices than a cluster holds, or the token loop is long (_plan: on this
//   card the barrier cost ~0.9 us a block more than this path), each
//   cluster writes its sums to device scratch [chunk][T][Din] and a second
//   small launch adds the chunks in order, then applies f'(Z) and kq_g.
//   int8 sums are int32 up to the single rescale, exact in any order, so
//   G_out is bitwise the plain version's for every C and chunk count;
//   emulate's f32 sums run in a fixed order.
// * Token blocks through a cp.async ring.  G and X blocks (and the Z rows
//   of the CTA's share) stream through a four-stage ring, two blocks ahead,
//   in 16-byte copies where rows allow (else 4-byte copies, or byte loads
//   for ragged int8 rows), zero-filled past T and the edges; one load of G
//   feeds both products.  Each G tile is read by the Din/16 CTAs that need
//   it, not by every CTA; Z is read once, by the CTA that applies f'(Z).
// * Tensor cores for int8.  Eq. 8 contracts over o, and G [t][o] and
//   q_w(W) [i][o] are both o-contiguous: the mma.sync m16n8k32 s8 A-row /
//   B-col operands as they are staged (q_w(W)'s fragments are held in
//   registers for the whole loop).  Eq. 9 contracts over t: G and X are
//   transposed from the ring into [o][t] and [i][t] tiles in 4x4 byte
//   squares with __byte_perm (the transposition of sgd_dw_update.cu).
// * f32 register tiles for emulate.  G is transposed into a [o][t] tile in
//   4x4 squares, so that both products are outer products of 4 x 4
//   outputs a thread: two 16-byte shared loads feed 16 FMAs.
// * The absmax of W is a whole-tensor value that no tile sees alone: a
//   small first launch writes partial maxima of |W| to device scratch and
//   each CTA finishes the max from them, so s_w never visits the host; the
//   frame is that launch's programmatic dependent, so it starts staging
//   its first blocks while the maxima are taken.
// Rounding follows the reference: s_w = am > 0 ? am / 127 : 1 (a
// division, not a reciprocal), payloads and kq by rintf (round half to
// even; kq multiplies by 2^F, which is exactly the division by its step),
// and every product and difference that the reference rounds separately is
// written with __fmul_rn / __fsub_rn so that nvcc cannot contract it into
// an FMA.  Ragged edges are masked.
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing (scratch comes from the caller),
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int TI = 16;                // Din rows a CTA
constexpr int TO = 32;                // Dout columns a CTA (a slice)
constexpr int BT = 64;                // tokens a block
constexpr int THREADS = 128;
constexpr int MAX_CLUSTER = 8;        // Dout slices a cluster (portable)
constexpr int NPART = 64;             // partial maxima of |W|
constexpr int LDN = TO + 16;          // bytes a row of int8 [t][o], [i][o]
constexpr int LDT = BT + 16;          // bytes a row of int8 [o][t], [i][t]
constexpr int GP = BT + 4;            // floats a row of emulate Gᵀ [o][t]
constexpr int FIN_THREADS = 256;      // the chunk sum's launch

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

// The derivation unit f'(z) (kernels/common.py::act_deriv), one rounding
// per PyTorch op of the plain version, so nvcc contracts nothing into an
// FMA that PyTorch rounds twice (a reciprocal times 1 is the division;
// python scalars are f32 there).
__device__ __forceinline__ float act_deriv(float z, int act) {
  switch (act) {
    case 1: return z > 0.0f ? 1.0f : 0.0f;
    case 2: {
      const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
      return __fmul_rn(s, __fsub_rn(1.0f, s));
    }
    case 3: {
      const float t = tanhf(z);
      return __fsub_rn(1.0f, __fmul_rn(t, t));
    }
    case 4: {
      const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
      return __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(z, __fsub_rn(1.0f, s))));
    }
    case 5: {
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
    }
    default: return 1.0f;
  }
}

struct Args {
  const void* g;            // [T, Dout] f32 or int8 payload
  const float* w;           // [Din, Dout] f32 master
  const void* x;            // [T, Din] f32 or int8 payload
  const float* z;           // [T, Din]
  const float* g_scale;     // int8: s_g (device scalar)
  const float* x_scale;     // int8: s_x (device scalar)
  const float* lr_ptr;      // lr on the device, or null: lr_val
  float lr_val;
  const float* partial;     // int8 absmax: partial maxima of |W|
  int npart;                // 0: W on its exact (I,F) grid (w_scale, ...)
  float w_scale, w_qmin, w_qmax;
  float* gout;              // [T, Din]
  float* wout;              // [Din, Dout]
  void* scratch;            // chunks > 1: [chunks][T][Din] int32 or f32
  int T, Din, Dout;
  int C;                    // Dout slices a cluster (gridDim.x = C·chunks)
  int chunks;
  int vg, vx, vz;           // rows of G / X / Z are whole 16-byte pieces
  int act;
  Bits bg, bwq, bwo;        // kq_g, q_w (emulate), kq_w'
};

__device__ __forceinline__ float lr_of(const Args& a) {
  return a.lr_ptr != nullptr ? a.lr_ptr[0] : a.lr_val;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// s_w, W's int8 scale, by every thread of the block: the exact grid's, or
// the whole-tensor absmax's from the partial maxima (max is exact, so the
// order of the reduction does not matter).  red: blockDim.x / 32 floats.
__device__ __forceinline__ float s_w_of(const Args& a, float* red) {
  if (a.npart == 0) return a.w_scale;
  // the absmax launch's partials (a no-op unless this grid was launched
  // as its programmatic dependent)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float m = (int)threadIdx.x < a.npart ? a.partial[threadIdx.x] : 0.0f;
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float am = 0.0f;
  for (int k = 0; k < (int)blockDim.x / 32; ++k) am = fmaxf(am, red[k]);
  return am > 0.0f ? am / 127.0f : 1.0f;
}

// partial[b] = max |w| over a grid-stride share of W.
__global__ void __launch_bounds__(256)
fused_unit_absmax_kernel(const float* __restrict__ w, size_t n,
                         float* __restrict__ partial) {
  __shared__ float red[8];
  // the frame may launch now: it reads the partials only after its wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  float m = 0.0f;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x)
    m = fmaxf(m, fabsf(w[e]));
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < 8 ? red[threadIdx.x] : 0.0f;
    m = warp_max(m);
    if (threadIdx.x == 0) partial[blockIdx.x] = m;
  }
}

// G_out from a full sum over Dout: int8 rescales by s_g·s_w first.
template <typename Acc>
__device__ __forceinline__ float gout_of(Acc s, float z, float gsw,
                                         const Args& a) {
  float y;
  if constexpr (std::is_same<Acc, int>::value)
    y = __fmul_rn((float)s, gsw);
  else
    y = s;
  return kq(__fmul_rn(y, act_deriv(z, a.act)), a.bg);
}

// kq_w'(W − lr·dW) in the reference's rounding order.
__device__ __forceinline__ float w_new(float wv, float dw, float lr,
                                       const Bits& b) {
  return kq(__fsub_rn(wv, __fmul_rn(lr, dw)), b);
}

// ------------------------------------------------------------- staging

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

// The ring: NS stages, block b + PD staged while block b is summed (after
// the cluster barrier's arrival, which would otherwise wait for the
// copies), into the stage of block b - 2: block b - 1's Z is still to be
// read.
constexpr int NS = 4;
constexpr int PD = 2;

// Rows t0 .. t0+rows-1, columns c0 .. c0+W-1 of a row-major [T, ld] f32
// matrix into dst[rows][W]; zero past T and past ld (the copy's src-size 0
// fills zeros).  vec: ld % 4 == 0 and the base 16-byte aligned, so a
// 4-column segment is wholly inside or wholly outside.
template <int W>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int rows, int t0, int T, int c0,
                                          int ld, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * W / 4; e += THREADS) {
      const int r = e / (W / 4), c = (e % (W / 4)) * 4;
      const bool ok = t0 + r < T && c0 + c < ld;
      cp16(dst + r * W + c, ok ? src + (size_t)(t0 + r) * ld + c0 + c : src,
           ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * W; e += THREADS) {
      const int r = e / W, c = e % W;
      const bool ok = t0 + r < T && c0 + c < ld;
      cp4(dst + r * W + c, ok ? src + (size_t)(t0 + r) * ld + c0 + c : src,
          ok ? 4 : 0);
    }
  }
}

// Rows t0 .. t0+BT-1, columns c0 .. c0+W-1 (W = 16 or 32) of a row-major
// [T, ld] int8 matrix into dst[BT][pitch]: 16-byte copies where vec (ld %
// 16 == 0 and the base 16-byte aligned), else byte loads stored at once
// (ragged or unaligned rows); zero past T and ld.
template <int W>
__device__ __forceinline__ void stage_i8(int8_t* dst, int pitch,
                                         const int8_t* src, int t0, int T,
                                         int c0, int ld, bool vec) {
  for (int e = threadIdx.x; e < BT * (W / 16); e += THREADS) {
    const int r = e / (W / 16), c = (e % (W / 16)) * 16;
    int8_t* d = dst + r * pitch + c;
    const int8_t* row = src + (size_t)(t0 + r) * ld + c0 + c;
    if (vec) {
      const bool ok = t0 + r < T && c0 + c < ld;
      cp16(d, ok ? row : src, ok ? 16 : 0);
    } else {
      unsigned v[4] = {0u, 0u, 0u, 0u};
      if (t0 + r < T)
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (c0 + c + k < ld)
            v[k / 4] |= (unsigned)(uint8_t)row[k] << (8 * (k % 4));
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ------------------------------------------------- the cluster's Eq. 8 sum

// The phases of the cluster barrier.  With C = 1 there is no cluster and a
// CTA barrier takes its place.  start: arrived at when the kernel begins,
// so that a wait before the first push ensures every peer runs before its
// shared memory is written.
struct Phases {
  int C;
  __device__ __forceinline__ void start() const {
    if (C > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::
                                : "memory");
  }
  __device__ __forceinline__ void arrive() const {
    if (C > 1)
      asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
    else
      __syncthreads();
  }
  __device__ __forceinline__ void wait() const {
    if (C > 1)
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    else
      __syncthreads();
  }
};

// Entries e .. e+V-1 of a partial block (E entries [t][i], row-major) into
// the inbox of CTA e / per, at `slot` (this CTA's rank, or with several
// partials a CTA, rank · partials + which), as one store to its shared
// memory.
template <typename VT, typename Acc>
__device__ __forceinline__ void push(Acc* inbox, int per, int C, int slot,
                                     int e, VT v) {
  const int owner = e / per;
  Acc* dst = inbox + slot * per + (e - owner * per);
  if (C > 1) dst = cg::this_cluster().map_shared_rank(dst, owner);
  *reinterpret_cast<VT*>(dst) = v;
}

// A CTA's share of a block: its entries [rank·per, (rank+1)·per) of the
// [BT x TI] block, BT / C whole token rows; a thread sums the pairs j,
// j + 1 of it, j = 2 * (threadIdx.x + u * THREADS), u < U.
struct Share {
  static constexpr int E = BT * TI;
  static constexpr int U = E / (2 * THREADS);   // C = 1 takes them all
  int per, rank, i0;
  __device__ __forceinline__ int j(int u) const {
    return 2 * ((int)threadIdx.x + u * THREADS);
  }
  __device__ __forceinline__ int t(int b, int u) const {
    return b * BT + (rank * per + j(u)) / TI;
  }
  __device__ __forceinline__ int i(int u) const { return i0 + j(u) % TI; }
  // Z's rows of the share of block b into dst[per / TI][TI]
  __device__ __forceinline__ void stage_z(float* dst, const Args& a,
                                          int b) const {
    stage_f32<TI>(dst, a.z, per / TI, b * BT + rank * (per / TI), a.T, i0,
                  a.Din, a.vz);
  }
};

// After the barrier that follows every push of block b: this CTA's share
// summed over its inbox's slots in slot order, then f'(Z) (zs: the share's
// Z, staged) and kq_g into G_out, or (chunks > 1) the cluster's sum into
// the scratch of its chunk.
template <typename Acc>
__device__ __forceinline__ void finish(const Acc* inbox, const Share& sh,
                                       int slots, int b, int chunk, float gsw,
                                       const Args& a, const float* zs) {
  using V2 = typename std::conditional<std::is_same<Acc, int>::value, int2,
                                       float2>::type;
#pragma unroll
  for (int u = 0; u < Share::U; ++u) {
    const int j = sh.j(u);
    if (j >= sh.per) continue;
    V2 s = *reinterpret_cast<const V2*>(inbox + j);
    for (int k = 1; k < slots; ++k) {
      const V2 p = *reinterpret_cast<const V2*>(inbox + k * sh.per + j);
      s.x += p.x;
      s.y += p.y;
    }
    const int t = sh.t(b, u), i = sh.i(u);
    if (t >= a.T) continue;
    const size_t idx = (size_t)t * a.Din + i;
    if (a.chunks == 1) {
      if (i < a.Din) a.gout[idx] = gout_of<Acc>(s.x, zs[j], gsw, a);
      if (i + 1 < a.Din)
        a.gout[idx + 1] = gout_of<Acc>(s.y, zs[j + 1], gsw, a);
    } else {
      Acc* dst = static_cast<Acc*>(a.scratch) +
                 (size_t)chunk * a.T * a.Din + idx;
      if (i < a.Din) dst[0] = s.x;
      if (i + 1 < a.Din) dst[1] = s.y;
    }
  }
}

// chunks > 1: G_out = the chunks' sums added in chunk order, then f'(Z)
// and kq_g.
template <typename Acc>
__global__ void __launch_bounds__(FIN_THREADS)
fused_unit_finish_kernel(Args a) {
  __shared__ float red[FIN_THREADS / 32];
  float gsw = 0.0f;
  if constexpr (std::is_same<Acc, int>::value)
    gsw = __fmul_rn(a.g_scale[0], s_w_of(a, red));
  const size_t n = (size_t)a.T * a.Din;
  const Acc* s = static_cast<const Acc*>(a.scratch);
  for (size_t e = (size_t)blockIdx.x * FIN_THREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * FIN_THREADS) {
    Acc v = s[e];
    for (int c = 1; c < a.chunks; ++c) v += s[(size_t)c * n + e];
    a.gout[e] = gout_of<Acc>(v, a.z[e], gsw, a);
  }
}

// ------------------------------------------------------------------ int8

// A 4x4 byte square transposed: r[j] holds row j (byte k = column k), c[k]
// column k (byte j = row j).
__device__ __forceinline__ void transpose4(const unsigned (&r)[4],
                                           unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The int8 CTA's shared memory, in bytes: the ring's stages of G [BT][LDN]
// and X [BT][LDX] as they are and Z's share (f32, at most [BT][TI]); Gᵀ
// [TO][LDT] and Xᵀ [TI][LDT], transposed from the ring each block; q_w(W)
// [TI][LDN]; the inbox [3][BT·TI] int32; the reduction of s_w.
struct I8 {
  static constexpr int LDX = TI + 16;
  static constexpr int GN = 0, XN = GN + BT * LDN, ZS = XN + BT * LDX;
  static constexpr int STAGE = ZS + BT * TI * 4;
  static constexpr int GT = NS * STAGE, XT = GT + TO * LDT;
  static constexpr int WQ = XT + TI * LDT, IN = WQ + TI * LDN;
  static constexpr int RED = IN + 3 * BT * TI * 4;
  static constexpr int BYTES = RED + 4 * (THREADS / 32);
  static_assert(STAGE % 16 == 0 && IN % 16 == 0, "alignment");
};

// Warps: Eq. 8's [64 tokens x TI] block, warp w the 16 tokens 16w..,
// TI / 8 tiles of 8 Din; Eq. 9's [TI x 32] dW, TI / 16 x 4 tiles of 16 x 8,
// NP = TI / 16 of them a warp.  C fragment e of a tile: row gq + 8 (e / 2),
// column 2 tg + e % 2.
__global__ void __launch_bounds__(THREADS) fused_unit_int8_kernel(Args a) {
  using L = I8;
  using Sh = Share;
  constexpr int NI = TI / 8, NP = TI / 16;
  extern __shared__ __align__(16) int8_t sm8[];
  int8_t* gt = sm8 + L::GT;
  int8_t* xt = sm8 + L::XT;
  int8_t* wq = sm8 + L::WQ;
  int* inbox = reinterpret_cast<int*>(sm8 + L::IN);
  const int8_t* g = static_cast<const int8_t*>(a.g);
  const int8_t* x = static_cast<const int8_t*>(a.x);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tg = lane % 4;
  const int C = a.C, rank = (int)blockIdx.x % C, chunk = (int)blockIdx.x / C;
  const int o0 = blockIdx.x * TO, i0 = blockIdx.y * TI;
  const int nb = (a.T + BT - 1) / BT;
  const Sh sh{Sh::E / C, rank, i0};
  const Phases ph{C};
  ph.start();

  auto slot = [&](int b) { return sm8 + (b % NS) * L::STAGE; };
  auto stage = [&](int b) {
    if (b < nb) {
      int8_t* st = slot(b);
      stage_i8<TO>(st + L::GN, LDN, g, b * BT, a.T, o0, a.Dout, a.vg);
      stage_i8<TI>(st + L::XN, L::LDX, x, b * BT, a.T, i0, a.Din, a.vx);
      if (a.chunks == 1)
        sh.stage_z(reinterpret_cast<float*>(st + L::ZS), a, b);
    }
    cp_commit();
  };
#pragma unroll
  for (int b = 0; b < PD; ++b) stage(b);

  // this thread's Eq. 9 tiles, its W values (kept for the update), q_w(W)
  auto w_row = [&](int q, int e) { return 16 * ((warp * NP + q) / 4) + gq +
                                          8 * (e / 2); };
  auto w_col = [&](int q, int e) { return 8 * ((warp * NP + q) % 4) +
                                          2 * tg + e % 2; };
  float wv[NP][4];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gi = i0 + w_row(q, e), go = o0 + w_col(q, e);
      wv[q][e] = gi < a.Din && go < a.Dout ? a.w[(size_t)gi * a.Dout + go]
                                           : 0.0f;
    }
  const float lr = lr_of(a), s_g = a.g_scale[0];
  const float dws = __fmul_rn(a.x_scale[0], s_g);             // s_x · s_g
  const float s_w = s_w_of(a, reinterpret_cast<float*>(sm8 + L::RED));
  const float gsw = __fmul_rn(s_g, s_w);                      // s_g · s_w
  const float qmin = a.npart > 0 ? -127.0f : a.w_qmin;
  const float qmax = a.npart > 0 ? 127.0f : a.w_qmax;
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wq[w_row(q, e) * LDN + w_col(q, e)] =
          (int8_t)(int)fminf(fmaxf(rintf(wv[q][e] / s_w), qmin), qmax);
  __syncthreads();
  unsigned wb[NI][2];                                // Eq. 8's B, all loop
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int8_t* p = wq + (8 * n + gq) * LDN + tg * 4;
    wb[n][0] = *reinterpret_cast<const unsigned*>(p);
    wb[n][1] = *reinterpret_cast<const unsigned*>(p + 16);
  }
  int dw[NP][4];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[q][e] = 0;
  int pg[NI][4];

  for (int b = 0; b < nb; ++b) {
    const int8_t* st = slot(b);
    cp_wait<PD - 1>();
    __syncthreads();          // block b landed; block b - 1's Gᵀ, Xᵀ free
    {                         // Gᵀ [o][t] and Xᵀ [i][t], 4x4 squares
      for (int q = tid; q < 16 * (TO / 4 + TI / 4); q += THREADS) {
        const bool is_g = q < 16 * (TO / 4);
        const int qq = is_g ? q : q - 16 * (TO / 4), nc = is_g ? TO / 4
                                                               : TI / 4;
        const int tq = qq / nc, cq = qq % nc;
        const int8_t* s = st + (is_g ? L::GN : L::XN) + 4 * tq * (is_g
            ? LDN : L::LDX) + 4 * cq;
        const int pitch = is_g ? LDN : L::LDX;
        unsigned r[4], c[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          r[k] = *reinterpret_cast<const unsigned*>(s + k * pitch);
        transpose4(r, c);
        int8_t* d = (is_g ? gt : xt) + 4 * cq * LDT + 4 * tq;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *reinterpret_cast<unsigned*>(d + k * LDT) = c[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BT / 32; ++ks)               // Eq. 9
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int mi = (warp * NP + q) / 4, nj = (warp * NP + q) % 4;
        const int8_t* pa = xt + (16 * mi + gq) * LDT + ks * 32 + tg * 4;
        const int8_t* pb = gt + (8 * nj + gq) * LDT + ks * 32 + tg * 4;
        const unsigned af[4] = {
            *reinterpret_cast<const unsigned*>(pa),
            *reinterpret_cast<const unsigned*>(pa + 8 * LDT),
            *reinterpret_cast<const unsigned*>(pa + 16),
            *reinterpret_cast<const unsigned*>(pa + 8 * LDT + 16)};
        const unsigned bf[2] = {*reinterpret_cast<const unsigned*>(pb),
                                *reinterpret_cast<const unsigned*>(pb + 16)};
        mma_s8(dw[q], af, bf);
      }
    {                                                  // Eq. 8
      const int8_t* pa = st + L::GN + (16 * warp + gq) * LDN + tg * 4;
      const unsigned af[4] = {
          *reinterpret_cast<const unsigned*>(pa),
          *reinterpret_cast<const unsigned*>(pa + 8 * LDN),
          *reinterpret_cast<const unsigned*>(pa + 16),
          *reinterpret_cast<const unsigned*>(pa + 8 * LDN + 16)};
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        pg[n][0] = pg[n][1] = pg[n][2] = pg[n][3] = 0;
        mma_s8(pg[n], af, wb[n]);
      }
    }
    ph.wait();                // phase b: block b - 3's inbox is read
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int h = 0; h < 4; h += 2)
        push<int2>(inbox + (b % 3) * Sh::E, sh.per, C, rank,
                   (16 * warp + gq + 4 * h) * TI + 8 * n + 2 * tg,
                   make_int2(pg[n][h], pg[n][h + 1]));
    ph.arrive();              // phase b + 1: block b's pushes are out
    stage(b + PD);            // into block b - 2's stage, read by all now
    if (b > 0)
      finish<int>(inbox + ((b - 1) % 3) * Sh::E, sh, C, b - 1, chunk,
                      gsw, a, reinterpret_cast<const float*>(slot(b - 1) +
                                                             L::ZS));
  }

  // Eq. 1 (dW is complete), then the last block's G_out
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gi = i0 + w_row(q, e), go = o0 + w_col(q, e);
      if (gi < a.Din && go < a.Dout)
        a.wout[(size_t)gi * a.Dout + go] =
            w_new(wv[q][e], __fmul_rn((float)dw[q][e], dws), lr, a.bwo);
    }
  ph.wait();
  if (nb > 0)
    finish<int>(inbox + ((nb - 1) % 3) * Sh::E, sh, C, nb - 1, chunk, gsw,
                    a, reinterpret_cast<const float*>(slot(nb - 1) + L::ZS));
}

// --------------------------------------------------------------- emulate

// N consecutive floats of shared memory (N = 1, 2, 4) in one load.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&r)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = p[0];
  }
}

// The emulate CTA: shared memory in floats -- the ring's stages of G
// [BT][TO], X [BT][TI] and Z's share (at most [BT][TI]); Gᵀ [TO][GP];
// q_w(W)ᵀ [TO][TI]; the inbox [3][NG8 · C slots of the share].  The
// threads as 4x4 register tiles: Eq. 9's [TI x 32] dW 2·TI of them, run
// by NG9 = BT / TI groups, each over its TI tokens of a block (the groups'
// dW summed in group order after the loop, in the ring's first stage);
// Eq. 8's [64 x TI] partial 4·TI of them, run by NG8 = TO / TI groups,
// each over its TI columns of the slice (its own slot of the inbox).  So
// a thread's inner step is two 16-byte shared loads and 16 FMAs in both
// products.
struct Emu {
  static constexpr int NG9 = BT / TI, NG8 = TO / TI;
  static constexpr int G = 0, X = G + BT * TO, Z = X + BT * TI;
  static constexpr int STAGE = Z + BT * TI;
  static constexpr int GT = NS * STAGE, WQ = GT + TO * GP, IN = WQ + TO * TI;
  static constexpr int IN_BUF = NG8 * BT * TI;
  static constexpr int FLOATS = IN + 3 * IN_BUF;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
  static_assert((NG9 - 1) * TI * TO <= Z, "the dW spill stays off Z");
};

__global__ void __launch_bounds__(THREADS) fused_unit_emulate_kernel(Args a) {
  using L = Emu;
  using Sh = Share;
  extern __shared__ __align__(16) float smem[];
  float* gtT = smem + L::GT;
  float* wqT = smem + L::WQ;
  float* inbox = smem + L::IN;
  const float* g = static_cast<const float*>(a.g);
  const float* x = static_cast<const float*>(a.x);
  const int tid = threadIdx.x;
  const int C = a.C, rank = (int)blockIdx.x % C, chunk = (int)blockIdx.x / C;
  const int o0 = blockIdx.x * TO, i0 = blockIdx.y * TI;
  const int nb = (a.T + BT - 1) / BT;
  const Sh sh{Sh::E / C, rank, i0};
  const Phases ph{C};
  ph.start();

  auto slot = [&](int b) { return smem + (b % NS) * L::STAGE; };
  auto stage = [&](int b) {
    if (b < nb) {
      float* st = slot(b);
      stage_f32<TO>(st + L::G, g, BT, b * BT, a.T, o0, a.Dout, a.vg);
      stage_f32<TI>(st + L::X, x, BT, b * BT, a.T, i0, a.Din, a.vx);
      if (a.chunks == 1) sh.stage_z(st + L::Z, a, b);
    }
    cp_commit();
  };
#pragma unroll
  for (int b = 0; b < PD; ++b) stage(b);

  // Eq. 9: token group g9, rows 4ty.., columns 4tx..; Eq. 8: column group
  // g8, tokens 4tt.., Din 4ti..
  const int g9 = tid / (2 * TI), ty = tid % (2 * TI) / 8, tx = tid % 8;
  const int g8 = tid / (4 * TI), tt = tid % (4 * TI) / (TI / 4);
  const int ti = tid % (TI / 4);
  // group 0's W values (kept for the update) and q_w(W)ᵀ
  float wv[4][4] = {};
  if (g9 == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gi = i0 + 4 * ty + r, go = o0 + 4 * tx + c;
        wv[r][c] = gi < a.Din && go < a.Dout ? a.w[(size_t)gi * a.Dout + go]
                                             : 0.0f;
        wqT[(4 * tx + c) * TI + 4 * ty + r] = kq(wv[r][c], a.bwq);
      }
  }
  const float lr = lr_of(a);
  float dw[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dw[r][c] = 0.0f;
  float pg[4][4];

  for (int b = 0; b < nb; ++b) {
    const float* gb = slot(b) + L::G;
    const float* xb = slot(b) + L::X;
    cp_wait<PD - 1>();
    __syncthreads();          // block b landed; block b - 1's Gᵀ is free
    {                         // Gᵀ: thread tid transposes one 4x4 square
      const int tq = tid / 8, oq = tid % 8;
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = *reinterpret_cast<const float4*>(gb + (4 * tq + k) * TO +
                                                4 * oq);
      *reinterpret_cast<float4*>(gtT + (4 * oq + 0) * GP + 4 * tq) =
          make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
      *reinterpret_cast<float4*>(gtT + (4 * oq + 1) * GP + 4 * tq) =
          make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
      *reinterpret_cast<float4*>(gtT + (4 * oq + 2) * GP + 4 * tq) =
          make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
      *reinterpret_cast<float4*>(gtT + (4 * oq + 3) * GP + 4 * tq) =
          make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
    }
#pragma unroll
    for (int k = 0; k < TI; ++k) {          // Eq. 9 over this group's tokens
      const int t = g9 * TI + k;
      float xr[4], gr[4];
      lds<4>(xb + t * TI + 4 * ty, xr);
      lds<4>(gb + t * TO + 4 * tx, gr);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dw[r][c] = fmaf(xr[r], gr[c], dw[r][c]);
    }
    __syncthreads();                        // Gᵀ is complete
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) pg[r][c] = 0.0f;
#pragma unroll
    for (int k = 0; k < TI; ++k) {          // Eq. 8 over this group's columns
      const int o = g8 * TI + k;
      float gr[4], wr[4];
      lds<4>(gtT + o * GP + 4 * tt, gr);
      lds<4>(wqT + o * TI + 4 * ti, wr);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) pg[r][c] = fmaf(gr[r], wr[c], pg[r][c]);
    }
    ph.wait();                // phase b: block b - 3's inbox is read
#pragma unroll
    for (int r = 0; r < 4; ++r)
      push<float4>(inbox + (b % 3) * L::IN_BUF, sh.per, C,
                   rank * L::NG8 + g8, (4 * tt + r) * TI + 4 * ti,
                   make_float4(pg[r][0], pg[r][1], pg[r][2], pg[r][3]));
    ph.arrive();              // phase b + 1: block b's pushes are out
    stage(b + PD);            // into block b - 2's stage, read by all now
    if (b > 0)
      finish<float>(inbox + ((b - 1) % 3) * L::IN_BUF, sh, C * L::NG8,
                        b - 1, chunk, 0.0f, a, slot(b - 1) + L::Z);
  }

  // dW: the token groups' partials, summed in group order by group 0 in
  // the ring's first stage (no copy is in flight now); then Eq. 1
  __syncthreads();
  float* part = smem;
  if (g9 > 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(part + ((g9 - 1) * TI + 4 * ty + r) * TO +
                                 4 * tx) =
          make_float4(dw[r][0], dw[r][1], dw[r][2], dw[r][3]);
  }
  __syncthreads();
  if (g9 == 0) {
    for (int k = 1; k < L::NG9; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float pr[4];
        lds<4>(part + ((k - 1) * TI + 4 * ty + r) * TO + 4 * tx, pr);
#pragma unroll
        for (int c = 0; c < 4; ++c) dw[r][c] += pr[c];
      }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gi = i0 + 4 * ty + r, go = o0 + 4 * tx + c;
        if (gi < a.Din && go < a.Dout)
          a.wout[(size_t)gi * a.Dout + go] = w_new(wv[r][c], dw[r][c], lr,
                                                   a.bwo);
      }
  }
  ph.wait();
  if (nb > 0)
    finish<float>(inbox + ((nb - 1) % 3) * L::IN_BUF, sh, C * L::NG8,
                      nb - 1, chunk, 0.0f, a, slot(nb - 1) + L::Z);
}

// ---------------------------------------------------------------- launch

// The plan (the wrapper's _plan) must tile W: C a power of two <=
// MAX_CLUSTER, and C·chunks slices of TO columns that cover Dout with at
// least one real slice in the last chunk; scratch for the chunk sums where
// chunks > 1.
bool plan_ok(const Args& a) {
  const int slices = (a.Dout + TO - 1) / TO;
  if (a.C < 1 || a.C > MAX_CLUSTER || (a.C & (a.C - 1)) != 0) return false;
  if (a.chunks != (slices + a.C - 1) / a.C) return false;
  return a.chunks == 1 || a.scratch != nullptr;
}

// The frame over a grid of C·chunks Dout slices x Din tiles, the C slices
// of a chunk one cluster (C x 1 x 1), as the absmax launch's programmatic
// dependent where one precedes it; then, with chunks > 1, the chunk sum.
template <typename Acc>
int launch(void (*kern)(Args), int smem, cudaStream_t stream,
           const Args& a) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C * a.chunks, (a.Din + TI - 1) / TI, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int na = 0;
  if (a.C > 1) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = a.C;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
  }
  if (a.npart > 0) {   // after the absmax launch: start while it runs
    attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[na].val.programmaticStreamSerializationAllowed = 1;
    ++na;
  }
  cfg.attrs = attr;
  cfg.numAttrs = na;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  if (a.chunks > 1) {
    const size_t n = (size_t)a.T * a.Din;
    const size_t want = (n + FIN_THREADS - 1) / FIN_THREADS;
    const unsigned blocks = (unsigned)(want < 1024 ? want : 1024);
    if (blocks > 0)
      fused_unit_finish_kernel<Acc><<<blocks, FIN_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

Args make_args(const void* g, const float* w, const void* x, const float* z,
               const float* lr_ptr, float lr_val, float* gout, float* wout,
               void* scratch, int T, int Din, int Dout, int C, int chunks,
               int vg, int vx, int vz, int act) {
  Args a = {};
  a.g = g; a.w = w; a.x = x; a.z = z;
  a.lr_ptr = lr_ptr; a.lr_val = lr_val;
  a.gout = gout; a.wout = wout; a.scratch = scratch;
  a.T = T; a.Din = Din; a.Dout = Dout;
  a.C = C; a.chunks = chunks; a.vg = vg; a.vx = vx; a.vz = vz;
  a.act = act;
  return a;
}

}  // namespace

// C: Dout slices of 32 columns a cluster (TI = 16 Din rows a CTA);
// chunks: clusters along Dout, ceil(ceil(Dout / 32) / C); scratch:
// chunks·T·Din floats when chunks > 1, else unused.  vg / vx / vz: 1 when
// that operand's rows may be copied in 16-byte pieces (Dout / Din / Din
// % 4 == 0, the base 16-byte aligned).
extern "C" int bp_fused_unit_emulate(
    const float* g, const float* w, const float* x, const float* z,
    const float* lr_ptr, float lr_val, float* gout, float* wout,
    void* scratch, int T, int Din, int Dout, int C, int chunks, int vg,
    int vx, int vz, int g_on, int g_i, int g_f, int wq_on, int wq_i,
    int wq_f, int wo_on, int wo_i, int wo_f, int act, cudaStream_t stream) {
  if (Din <= 0 || Dout <= 0) return 0;
  Args a = make_args(g, w, x, z, lr_ptr, lr_val, gout, wout, scratch, T, Din,
                     Dout, C, chunks, vg, vx, vz, act);
  if (!plan_ok(a)) return (int)cudaErrorInvalidValue;
  a.bg = make_bits(g_on, g_i, g_f);
  a.bwq = make_bits(wq_on, wq_i, wq_f);
  a.bwo = make_bits(wo_on, wo_i, wo_f);
  return launch<float>(fused_unit_emulate_kernel, Emu::BYTES, stream, a);
}

// w_exact = 1: W on its (I,F)-derived int8 grid (w_scale, w_qmin, w_qmax);
// w_exact = 0: whole-tensor absmax of W, reduced into `partial` (NPART
// floats of device scratch) by a first launch on the same stream.  vg / vx:
// Dout / Din % 16 == 0 and the base 16-byte aligned; vz: Din % 4 == 0 and
// Z's base 16-byte aligned.  scratch: chunks·T·Din
// int32 when chunks > 1.
extern "C" int bp_fused_unit_int8(
    const void* g, const float* w, const void* x, const float* z,
    const float* g_scale, const float* x_scale, const float* lr_ptr,
    float lr_val, float* partial, int w_exact, float w_scale, int w_qmin,
    int w_qmax, float* gout, float* wout, void* scratch, int T, int Din,
    int Dout, int C, int chunks, int vg, int vx, int vz, int g_on,
    int g_i, int g_f, int wo_on, int wo_i, int wo_f, int act,
    cudaStream_t stream) {
  if (Din <= 0 || Dout <= 0) return 0;
  Args a = make_args(g, w, x, z, lr_ptr, lr_val, gout, wout, scratch, T, Din,
                     Dout, C, chunks, vg, vx, vz, act);
  if (!plan_ok(a)) return (int)cudaErrorInvalidValue;
  a.g_scale = g_scale;
  a.x_scale = x_scale;
  a.partial = partial;
  a.w_scale = w_scale;
  a.w_qmin = (float)w_qmin;
  a.w_qmax = (float)w_qmax;
  a.bg = make_bits(g_on, g_i, g_f);
  a.bwo = make_bits(wo_on, wo_i, wo_f);
  if (!w_exact) {
    const size_t n = (size_t)Din * Dout;
    const size_t nb = (n + 255) / 256;
    a.npart = (int)(nb < (size_t)NPART ? nb : (size_t)NPART);
    fused_unit_absmax_kernel<<<a.npart, 256, 0, stream>>>(w, n, partial);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  return launch<int>(fused_unit_int8_kernel, I8::BYTES, stream, a);
}
