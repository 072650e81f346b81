// sgd_dw_update: fused dW = XᵀG and SGD step, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sgd_dw_update.py::sgd_dw_update, the Pallas
// TPU kernel bodies _kernel (emulate) and _kernel_int8 (int8 MXU datapath).
//
//   emulate: W_new = kq_w(W − lr · XᵀG)                    X, G, W f32
//   int8:    W_new = kq_w(W − lr · scale · int32(qXᵀ @ qG)) exact int32 sums
//   w absent (the dW-only form of the dense unit's backward): kq_w(dW)
//
// with X [T, Din], G [T, Dout], W [Din, Dout] -> [Din, Dout] f32.  The
// contraction runs over the T tokens, down the columns of both operands.
//
// What bounds it on this card: each weight takes T multiply-adds while
// its f32 master is read once and written once.  At the LeNet shapes
// (T = 128) that is ~32 operations per byte: the emulate step sits at the
// f32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s), the int8 step is bound
// by the bytes of W.  At T = 2048 (a dense LM layer) both are bound by
// their operations.  In practice, at these sizes, the limits are the
// latency of the token loop and how many SMs have work.
//
// What the design does about that:
// * Register tiles.  emulate, where the tiles alone fill the card (the
//   dense LM layer): a CTA owns 64x128 outputs (Din x Dout) with 128
//   threads, each an 8x8 outer-product micro-tile, so that four 16-byte
//   shared loads feed 64 FMAs; at most 170 registers a thread keep 3 CTAs
//   on an SM.  Where the token split has to fill the card (LeNet): 64x64
//   outputs with 256 threads of 4x4 (two loads per 16 FMAs), 4 CTAs an SM,
//   whose many warps hide the latency that bounds such short products.
//   int8: a CTA owns 64x64 outputs with 4 warps, each 32x32 outputs as 2x4
//   tensor-core tiles of mma.sync m16n8k32 s8·s8 -> s32 (exact integer
//   sums).
// * Asynchronous staging.  emulate stages [16 tokens x 64] and [16 x 64
//   or 128] tiles of X and G with cp.async in a 4-stage ring; a row segment
//   is one 16-byte copy where the row is 16-byte aligned, else 4-byte
//   copies (the head's Dout = 10), and the ragged edge (Din = 784) and the
//   token tail are zero-filled by the copy itself.  int8 keeps the next
//   two 64-token tiles in flight in registers (16-byte row segments) while
//   the tensor cores work on the current one, so a two-tile run (LeNet's
//   batch of 128) waits for one load, not two.
// * Token axis contiguous for the tensor cores.  Both mma operands need 4
//   consecutive tokens in one 32-bit register, but X and G are [T, D]
//   row-major.  Each thread loads a 4-token x 16-column block as four
//   16-byte row segments and transposes its 4x4 byte blocks with
//   __byte_perm while writing the staged tile, [column][token] with a
//   row pitch of 80 bytes that keeps the fragment loads free of bank
//   conflicts.
// * Split over tokens, summed inside a thread-block cluster.  When the
//   output tiles cannot fill the card (LeNet: 4x1 tiles of 64x64 for
//   w_out, 13x4 for w_in), the grid's z axis cuts the token tiles into S <= 16
//   contiguous runs (the wrapper picks S from the SM count), and the S
//   CTAs of one output tile form a cluster.  Each puts its partial dW (f32
//   for emulate, int32 for int8) in its own shared memory, where the
//   staged tiles were; after a cluster barrier, CTA r sums its 1/S of the
//   tile over the S partials in split order, reading its peers' shared
//   memory, and runs the epilogue; a second barrier keeps each CTA's
//   shared memory until its peers have read it.  So a split costs no
//   second launch and no round trip through device memory, which at the
//   LeNet step's batch of 128 cost more than the split saved.  int32 sums
//   are exact, so the int8 result is bitwise the same for any S.
// * Epilogue in the reference's rounding: lr · dW rounds, then the
//   subtraction rounds (__fmul_rn / __fsub_rn, so nvcc cannot contract
//   them into an FMA), then kq_w with rintf (round half to even).  lr comes
//   from device memory when the caller passes a tensor, else by value.
//   lr, the scale and a thread's W values are read before it stores any
//   output: the compiler cannot tell that out aliases none of them, and
//   would otherwise wait for each store before the next load.  int8 reads
//   them before its token loop, so that their latency is hidden.
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

constexpr int TM_F = 64;            // emulate CTA tile: Din rows
constexpr int BK_F = 16;            // tokens per staged tile, emulate
constexpr int STAGES = 4;           // cp.async ring depth, emulate
constexpr int TILE = 64;            // int8 CTA tile: Din rows, Dout columns
constexpr int BK_I = 64;            // tokens per staged tile, int8
constexpr int THREADS_I = 128;      // 2x2 warps of 32x32 outputs
constexpr int LDT = BK_I + 16;      // bytes per row of a [column][token] tile
constexpr int MAX_SPLITS = 16;      // CTAs a cluster (Hopper's limit)

// kq_w's (I,F) grid: step 2^-F; inv = 2^F, so that x * inv is exactly
// x / step (a power of two) without a division
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

struct Args {
  const void* x;          // [T, Din] f32 or int8
  const void* g;          // [T, Dout] f32 or int8
  const float* scale;     // int8: s_x * s_g (device scalar)
  const float* w;         // [Din, Dout] f32 or null
  const float* lr_ptr;    // device lr or null
  float lr_val;
  float* out;             // [Din, Dout] f32
  int T, Din, Dout;
  int per;                // token tiles per split
  int vx, vg;             // rows 16-byte aligned: 16-byte copies
  Bits bw;
};

__device__ __forceinline__ float kq(float x, const Bits& b) {
  if (!b.on) return x;
  float k = fminf(fmaxf(rintf(x * b.inv), b.qmin), b.qmax);
  return k * b.step;
}

// The update's inputs, read before any output is stored: out may alias
// nothing, but the compiler cannot know that, and a load after a store
// waits for it.
__device__ __forceinline__ float lr_of(const Args& a) {
  return a.w == nullptr ? 0.0f : a.lr_ptr != nullptr ? a.lr_ptr[0] : a.lr_val;
}
__device__ __forceinline__ bool in_w(const Args& a, int gi, int gj) {
  return gi < a.Din && gj < a.Dout;
}
__device__ __forceinline__ float w_at(const Args& a, int gi, int gj) {
  return a.w != nullptr && in_w(a, gi, gj) ? a.w[(size_t)gi * a.Dout + gj]
                                           : 0.0f;
}

// kq_w(W − lr·dW), or kq_w(dW) without W, in the reference's rounding
// order; wv is W[gi, gj], read beforehand.
__device__ __forceinline__ void epilogue(float dw, float wv, float lr,
                                         const Args& a, int gi, int gj) {
  if (!in_w(a, gi, gj)) return;
  const float v = a.w != nullptr ? __fsub_rn(wv, __fmul_rn(lr, dw)) : dw;
  a.out[(size_t)gi * a.Dout + gj] = kq(v, a.bw);
}

// The split's sum, once every CTA of the cluster has put its partial tile
// (ROWS x COLS, row-major) at `part` in its own shared memory: CTA r takes
// the r-th 1/S of the tile's 4-element vectors, sums each over the S
// partials in rank (split) order, and stores it through the epilogue;
// int32 sums are rescaled once by `scale`.
template <typename Acc, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void cluster_reduce(Acc* part, const Args& a,
                                               int i0, int j0, float lr,
                                               float scale) {
  using V = typename std::conditional<std::is_same<Acc, int>::value, int4,
                                      float4>::type;
  constexpr int NV = ROWS * COLS / 4;
  constexpr int MAXV = (NV / 2 + THREADS - 1) / THREADS;  // S >= 2
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();                       // every partial is in place
  const int S = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int per = (NV + S - 1) / S, v0 = r * per;
  const int v1 = v0 + per < NV ? v0 + per : NV;
  float wv[MAXV][4];
  V sum[MAXV];
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int v = v0 + u * THREADS + (int)threadIdx.x;
    const int gi = i0 + v * 4 / COLS, gj = j0 + v * 4 % COLS;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wv[u][q] = v < v1 ? w_at(a, gi, gj + q) : 0.0f;
    sum[u].x = sum[u].y = sum[u].z = sum[u].w = 0;
  }
  for (int k = 0; k < S; ++k) {
    const V* pk = reinterpret_cast<const V*>(cl.map_shared_rank(part, k));
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int v = v0 + u * THREADS + (int)threadIdx.x;
      if (v < v1) {
        const V p = pk[v];
        sum[u].x += p.x; sum[u].y += p.y; sum[u].z += p.z; sum[u].w += p.w;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < MAXV; ++u) {
    const int v = v0 + u * THREADS + (int)threadIdx.x;
    if (v >= v1) continue;
    const int gi = i0 + v * 4 / COLS, gj = j0 + v * 4 % COLS;
    const Acc e[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float dw = std::is_same<Acc, int>::value
                           ? __fmul_rn((float)e[q], scale) : (float)e[q];
      epilogue(dw, wv[u][q], lr, a, gi, gj + q);
    }
  }
  cl.sync();                       // the peers have read this partial
}

// This split's token tiles: [kb, kb + nk) of ceil(T / bk).
__device__ __forceinline__ int split_tiles(const Args& a, int bk, int* kb) {
  const int all = (a.T + bk - 1) / bk;
  *kb = blockIdx.z * a.per;
  const int n = all - *kb;
  return n < 0 ? 0 : (n < a.per ? n : a.per);
}

// ---------------------------------------------------------------- emulate

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

// The emulate CTA for MT x MT outputs a thread (MT = 8 or 4): TY x 16
// threads own a TM_F x TN tile, thread (ty, tx) rows {ty*4 + h*TY*4} + 0..3
// and columns {tx*4 + h*64} + 0..3 for h < MT/4, so that each is one
// 16-byte shared load and the 16 lanes of a row of threads read 256
// contiguous bytes (no conflicts).
template <int MT>
struct Emu {
  static constexpr int H = MT / 4, TY = TM_F / MT, TN = 16 * MT;
  static constexpr int THREADS = TY * 16;
  static constexpr int SMEM = STAGES * BK_F * (TM_F + TN) * (int)sizeof(float);
  static_assert(SMEM <= 48 * 1024 && SMEM >= TM_F * TN * 4, "smem");
  static __device__ __forceinline__ int row(int ty, int r) {
    return (r / 4) * TY * 4 + ty * 4 + (r & 3);
  }
  static __device__ __forceinline__ int col(int tx, int c) {
    return (c / 4) * 64 + tx * 4 + (c & 3);
  }
};

// Rows t0 .. t0+BK_F-1, columns c0 .. c0+W-1 of a row-major [T, ld] f32
// matrix into dst[BK_F][W] by THREADS threads; zero past T and past ld (the
// copy's src-size 0 fills zeros).  vec: ld % 4 == 0 and the base 16-byte
// aligned, so a 4-column segment is wholly inside or wholly outside.
template <int W, int THREADS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int t0,
                                          int T, int c0, int ld, bool vec) {
  if (vec) {
#pragma unroll
    for (int e = threadIdx.x; e < BK_F * W / 4; e += THREADS) {
      const int r = e / (W / 4), c = (e % (W / 4)) * 4;
      const bool ok = t0 + r < T && c0 + c < ld;
      cp16(dst + r * W + c, ok ? src + (size_t)(t0 + r) * ld + c0 + c : src,
           ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK_F * W; e += THREADS) {
      const int r = e / W, c = e % W;
      const bool ok = t0 + r < T && c0 + c < ld;
      cp4(dst + r * W + c, ok ? src + (size_t)(t0 + r) * ld + c0 + c : src,
          ok ? 4 : 0);
    }
  }
}

// At least 3 (MT 8) or 4 (MT 4) CTAs an SM: enough warps to hide the
// shared-memory latency
template <int MT>
__global__ void __launch_bounds__(Emu<MT>::THREADS, MT == 8 ? 3 : 4)
sgd_dw_emulate_kernel(Args a) {
  using E = Emu<MT>;
  constexpr int TN = E::TN, H = E::H;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [STAGES][BK_F][TM_F]
  float* gs = smem + STAGES * BK_F * TM_F;   // [STAGES][BK_F][TN]
  const float* x = static_cast<const float*>(a.x);
  const float* g = static_cast<const float*>(a.g);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * TM_F, j0 = blockIdx.x * TN;
  int kb;
  const int nk = split_tiles(a, BK_F, &kb);

  auto stage = [&](int kt) {
    const int st = kt % STAGES, t0 = (kb + kt) * BK_F;
    stage_f32<TM_F, E::THREADS>(xs + st * BK_F * TM_F, x, t0, a.T, i0, a.Din,
                                a.vx);
    stage_f32<TN, E::THREADS>(gs + st * BK_F * TN, g, t0, a.T, j0, a.Dout,
                              a.vg);
  };
  float acc[MT][MT];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < MT; ++c) acc[r][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();               // tile kt landed; tile kt-1 is free
    if (kt + STAGES - 1 < nk) stage(kt + STAGES - 1);
    cp_commit();
    const float* xt = xs + (kt % STAGES) * BK_F * TM_F + ty * 4;
    const float* gt = gs + (kt % STAGES) * BK_F * TN + tx * 4;
#pragma unroll
    for (int k = 0; k < BK_F; ++k) {
      float ar[MT], br[MT];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 av =
            *reinterpret_cast<const float4*>(xt + k * TM_F + h * E::TY * 4);
        const float4 bv =
            *reinterpret_cast<const float4*>(gt + k * TN + h * 64);
        ar[4 * h] = av.x; ar[4 * h + 1] = av.y; ar[4 * h + 2] = av.z;
        ar[4 * h + 3] = av.w;
        br[4 * h] = bv.x; br[4 * h + 1] = bv.y; br[4 * h + 2] = bv.z;
        br[4 * h + 3] = bv.w;
      }
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < MT; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
  }
  const float lr = lr_of(a);
  if (gridDim.z > 1) {
    // the partial [TM_F][TN] over the staged tiles, which are free now
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int h = 0; h < MT; h += 4)
        *reinterpret_cast<float4*>(smem + E::row(ty, r) * TN + E::col(tx, h)) =
            make_float4(acc[r][h], acc[r][h + 1], acc[r][h + 2],
                        acc[r][h + 3]);
    cluster_reduce<float, TM_F, TN, E::THREADS>(smem, a, i0, j0, lr, 1.0f);
    return;
  }
#pragma unroll
  for (int h = 0; h < MT; h += 4) {   // 4 rows at a time: registers
    float wv[4][MT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < MT; ++c)
        wv[r][c] = w_at(a, i0 + E::row(ty, h + r), j0 + E::col(tx, c));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < MT; ++c)
        epilogue(acc[h + r][c], wv[r][c], lr, a, i0 + E::row(ty, h + r),
                 j0 + E::col(tx, c));
  }
}

// ------------------------------------------------------------------- int8

// A 4-token x 16-column block of a row-major [T, ld] int8 matrix at
// (t, col), as 4 token rows of 4 little-endian words; zero past T and ld.
// vec: ld % 16 == 0 and the base 16-byte aligned (one 16-byte load a row).
__device__ __forceinline__ void load_block(unsigned (&r)[4][4],
                                           const int8_t* p, int t, int T,
                                           int col, int ld, bool vec) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int tt = t + j;
    r[j][0] = r[j][1] = r[j][2] = r[j][3] = 0u;
    if (tt >= T || col >= ld) continue;
    const int8_t* row = p + (size_t)tt * ld + col;
    if (vec) {
      const uint4 v = *reinterpret_cast<const uint4*>(row);
      r[j][0] = v.x; r[j][1] = v.y; r[j][2] = v.z; r[j][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (col + e < ld)
          r[j][e / 4] |= (unsigned)(uint8_t)row[e] << (8 * (e % 4));
    }
  }
}

// Transpose the block's 4x4 byte squares and store it as 16 column rows of
// 4 tokens: dst[(c) * LDT + tq * 4], c = 0..15.
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

__global__ void __launch_bounds__(THREADS_I) sgd_dw_int8_kernel(Args a) {
  // [buffer][column][token]: Xᵀ rows are Din columns, Gᵀ rows Dout columns;
  // after the token loop, a split's partial [TILE][TILE] int32
  __shared__ __align__(16) union {
    struct {
      int8_t x[2][TILE * LDT], g[2][TILE * LDT];
    } st;
    int part[TILE * TILE];
  } sm;
  auto& xsT = sm.st.x;
  auto& gsT = sm.st.g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  int kb;
  const int nk = split_tiles(a, BK_I, &kb);

  // loader: threads 0-63 take X's 64 blocks, 64-127 G's; a warp holds 16
  // token quads x 2 column chunks (coalesced 32-byte row pieces)
  const bool is_x = tid < 64;
  const int blk = tid % 64, tq = blk % 16, cb = blk / 16;
  const int8_t* src = static_cast<const int8_t*>(is_x ? a.x : a.g);
  const int ld = is_x ? a.Din : a.Dout;
  const int col = (is_x ? i0 : j0) + cb * 16;
  const bool vec = is_x ? a.vx : a.vg;
  // two token tiles in flight in registers: ra (even tiles), rb (odd)
  unsigned ra[4][4], rb[4][4];
  auto fetch = [&](unsigned (&r)[4][4], int kt) {
    if (kt < nk)
      load_block(r, src, (kb + kt) * BK_I + tq * 4, a.T, col, ld, vec);
  };
  auto put = [&](const unsigned (&r)[4][4], int buf) {
    put_block(r, (is_x ? xsT[buf] : gsT[buf]) + cb * 16 * LDT + tq * 4);
  };

  // compute: warp (wm, wn) owns rows wm*32.., columns wn*32..; C fragment:
  // e = 0,1 at row gq, e = 2,3 at row gq + 8, column tg*2 + e%2
  const int wm = warp / 2, wn = warp % 2, gq = lane / 4, tg = lane % 4;
  auto out_row = [&](int m, int e) {
    return i0 + wm * 32 + m * 16 + gq + (e / 2) * 8;
  };
  auto out_col = [&](int n, int e) {
    return j0 + wn * 32 + n * 8 + tg * 2 + e % 2;
  };
  int acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;

  auto mma_tile = [&](int buf) {
#pragma unroll
    for (int ks = 0; ks < BK_I / 32; ++ks) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int8_t* p = xsT[buf] + (wm * 32 + m * 16 + gq) * LDT + ks * 32 +
                          tg * 4;
        af[m][0] = *reinterpret_cast<const unsigned*>(p);
        af[m][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDT);
        af[m][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[m][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDT + 16);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int8_t* p = gsT[buf] + (wn * 32 + n * 8 + gq) * LDT + ks * 32 +
                          tg * 4;
        bf[n][0] = *reinterpret_cast<const unsigned*>(p);
        bf[n][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_s8(acc[m][n], af[m], bf[n]);
    }
  };

  // tile kt is staged in buffer kt & 1; while the tensor cores work on it,
  // the next is staged from registers and the one after is loaded
  fetch(ra, 0);
  fetch(rb, 1);
  // the update's inputs next, so that their loads overlap the token loop's
  // (a split reads W in its sum instead)
  const float lr = lr_of(a), scale = a.scale[0];
  float wv[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wv[m][n][e] =
            gridDim.z == 1 ? w_at(a, out_row(m, e), out_col(n, e)) : 0.0f;
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
    __syncthreads();               // the staged tiles are free
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<int2*>(
              sm.part + (out_row(m, e) - i0) * TILE + out_col(n, e) - j0) =
              make_int2(acc[m][n][e], acc[m][n][e + 1]);
    cluster_reduce<int, TILE, TILE, THREADS_I>(sm.part, a, i0, j0, lr, scale);
    return;
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epilogue(__fmul_rn((float)acc[m][n][e], scale), wv[m][n][e], lr, a,
                 out_row(m, e), out_col(n, e));
}

// The product over a grid of S splits; with S > 1 the S CTAs of an output
// tile form one cluster (1 x 1 x S); more than 8 is a non-portable size.
int launch(void (*kern)(Args), dim3 grid, int threads, int smem,
           cudaStream_t stream, const Args& a) {
  if (grid.z > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

dim3 grid_for(int Din, int Dout, int tm, int tn, int S) {
  return dim3((Dout + tn - 1) / tn, (Din + tm - 1) / tm, S);
}

// The split plan must cover every token tile exactly once, in order, with
// no empty split: per >= 1, (S - 1) * per < ceil(T / bk) <= S * per, and
// fit one cluster: S <= MAX_SPLITS.
bool plan_ok(int T, int bk, int per, int S) {
  const int nk = (T + bk - 1) / bk;
  if (S < 1 || S > MAX_SPLITS || per < 0) return false;
  if (nk == 0) return S == 1;
  return per >= 1 && (S - 1) * per < nk && nk <= S * per;
}

Args make_args(const void* x, const void* g, const float* scale,
               const float* w, const float* lr_ptr, float lr_val, float* out,
               int T, int Din, int Dout, int per, int vx, int vg, int w_on,
               int w_i, int w_f) {
  Args a;
  a.x = x; a.g = g; a.scale = scale; a.w = w;
  a.lr_ptr = lr_ptr; a.lr_val = lr_val; a.out = out;
  a.T = T; a.Din = Din; a.Dout = Dout; a.per = per;
  a.vx = vx; a.vg = vg;
  a.bw = make_bits(w_on, w_i, w_f);
  return a;
}

}  // namespace

// vx / vg: 1 when that operand's rows may be staged in 16-byte pieces
// (emulate: D % 4 == 0, int8: D % 16 == 0, base 16-byte aligned).
// S splits of `per` token tiles each, S <= 16.  mt: outputs a thread along
// each axis of the emulate tile, 8 (64x128 tiles) or 4 (64x64).
extern "C" int sgd_dw_update_emulate(const float* x, const float* g,
                                     const float* w, const float* lr_ptr,
                                     float lr_val, float* out, int T,
                                     int Din, int Dout, int per, int S,
                                     int mt, int vx, int vg, int w_on,
                                     int w_i, int w_f, cudaStream_t stream) {
  if (Din <= 0 || Dout <= 0) return 0;
  if (!plan_ok(T, BK_F, per, S) || (mt != 8 && mt != 4))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, g, nullptr, w, lr_ptr, lr_val, out, T, Din,
                           Dout, per, vx, vg, w_on, w_i, w_f);
  // the staging ring, which also holds a split's partial tile
  if (mt == 8)
    return launch(sgd_dw_emulate_kernel<8>,
                  grid_for(Din, Dout, TM_F, Emu<8>::TN, S), Emu<8>::THREADS,
                  Emu<8>::SMEM, stream, a);
  return launch(sgd_dw_emulate_kernel<4>,
                grid_for(Din, Dout, TM_F, Emu<4>::TN, S), Emu<4>::THREADS,
                Emu<4>::SMEM, stream, a);
}

extern "C" int sgd_dw_update_int8(const void* x, const void* g,
                                  const float* scale, const float* w,
                                  const float* lr_ptr, float lr_val,
                                  float* out, int T, int Din, int Dout,
                                  int per, int S, int vx, int vg, int w_on,
                                  int w_i, int w_f, cudaStream_t stream) {
  if (Din <= 0 || Dout <= 0) return 0;
  if (!plan_ok(T, BK_I, per, S)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, g, scale, w, lr_ptr, lr_val, out, T, Din, Dout,
                           per, vx, vg, w_on, w_i, w_f);
  return launch(sgd_dw_int8_kernel, grid_for(Din, Dout, TILE, TILE, S),
                THREADS_I, 0, stream, a);
}
