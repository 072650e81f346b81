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
// What bounds it on this card: on the LeNet path the contraction is over
// the head's Dout = 10 classes, so each output takes 10 multiply-adds and
// the launch moves G, W, Z and the output once: ~2 operations per byte,
// far below the ~300 where H100's arithmetic becomes the limit.  It is
// bound by the bytes of Z and of the output ([T, Din] f32 each).
//
// What the design does about that: one CTA per 8x32 output tile, one
// output per thread, so Z and the output are read and written in
// coalesced 32-float rows and T = 128 already gives 128 CTAs.  Wᵀ is never
// materialised: the kernel reads W[i, o] rows along o (coalesced along
// Dout) and writes them transposed into a padded shared tile, so the inner
// loop reads both operands from shared memory without bank conflicts.  The
// contraction walks Dout in 64-deep tiles.  The int8 path packs 4
// consecutive o values per 32-bit word and multiplies with __dp4a into an
// exact int32 accumulator, then rescales once.  The epilogue multiplies by
// f'(Z) and rounds onto the (I,F) grid with rintf (round half to even, like
// jnp.round; never roundf).  Ragged edges are masked (zero fill), so no
// dimension has to divide a tile.  Simple and right first: no TMA, wgmma
// or software pipelining yet.
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;               // token rows per CTA
constexpr int BN = 32;              // Din columns per CTA
constexpr int BK = 64;              // Dout depth per tile
constexpr int KG = BK / 4;          // packed int8 words per tile row
constexpr int THREADS = BM * BN;    // one output element per thread

struct Bits {
  int on;
  float step, qmin, qmax;
};

Bits make_bits(int on, int i_bits, int f_bits) {
  Bits b;
  b.on = on;
  b.step = ldexpf(1.0f, -f_bits);
  b.qmax = ldexpf(1.0f, i_bits + f_bits) - 1.0f;
  b.qmin = -ldexpf(1.0f, i_bits + f_bits);
  return b;
}

__device__ __forceinline__ float kq(float x, const Bits& b) {
  if (!b.on) return x;
  float k = fminf(fmaxf(rintf(x / b.step), b.qmin), b.qmax);
  return k * b.step;
}

// The derivation unit f'(z) (kernels/common.py::act_deriv).
__device__ __forceinline__ float act_deriv(float z, int act) {
  switch (act) {
    case 1: return z > 0.0f ? 1.0f : 0.0f;
    case 2: {
      float s = 1.0f / (1.0f + expf(-z));
      return s * (1.0f - s);
    }
    case 3: {
      float t = tanhf(z);
      return 1.0f - t * t;
    }
    case 4: {
      float s = 1.0f / (1.0f + expf(-z));
      return s * (1.0f + z * (1.0f - s));
    }
    case 5: {
      float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
      float t = tanhf(u);
      float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * z * z);
      return 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * du;
    }
    default: return 1.0f;
  }
}

// y ⊙ f'(z) (no derivative input: y), then kq_g; written as the reference
// writes it: the product rounds once, then the grid rounding.
__device__ __forceinline__ void epilogue(float y, const float* __restrict__ z,
                                         float* __restrict__ out, int gm,
                                         int gn, int T, int Din,
                                         const Bits& bg, int act) {
  if (gm >= T || gn >= Din) return;
  const size_t idx = (size_t)gm * Din + gn;
  if (z != nullptr) y = __fmul_rn(y, act_deriv(z[idx], act));
  out[idx] = kq(y, bg);
}

__global__ void __launch_bounds__(THREADS)
gstep_emulate_kernel(const float* __restrict__ g, const float* __restrict__ w,
                     const float* __restrict__ z, float* __restrict__ out,
                     int T, int Din, int Dout, Bits bg, int act) {
  __shared__ float gs[BM][BK];
  __shared__ float ws[BK][BN + 1];   // Wᵀ tile, padded against conflicts
  const int tid = threadIdx.x;
  const int r = tid / BN, c = tid % BN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc = 0.0f;
  for (int k0 = 0; k0 < Dout; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int rr = i / BK, kk = i % BK;
      const int gm = m0 + rr, gk = k0 + kk;
      gs[rr][kk] = (gm < T && gk < Dout) ? g[(size_t)gm * Dout + gk] : 0.0f;
    }
    // consecutive threads read consecutive o of one W row (coalesced)
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int cc = i / BK, kk = i % BK;
      const int gn = n0 + cc, gk = k0 + kk;
      ws[kk][cc] = (gn < Din && gk < Dout) ? w[(size_t)gn * Dout + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) acc = fmaf(gs[r][kk], ws[kk][c], acc);
    __syncthreads();
  }
  epilogue(acc, z, out, m0 + r, n0 + c, T, Din, bg, act);
}

__device__ __forceinline__ int pack4(const int8_t* __restrict__ p, int k,
                                     int kmax, bool row_ok) {
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned v = (row_ok && k + j < kmax) ? (uint8_t)p[k + j] : 0u;
    packed |= v << (8 * j);
  }
  return (int)packed;
}

__global__ void __launch_bounds__(THREADS)
gstep_int8_kernel(const int8_t* __restrict__ g, const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ z, float* __restrict__ out, int T,
                  int Din, int Dout, Bits bg, int act) {
  __shared__ int gs[BM][KG];
  __shared__ int ws[KG][BN + 1];
  const int tid = threadIdx.x;
  const int r = tid / BN, c = tid % BN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc = 0;
  for (int k0 = 0; k0 < Dout; k0 += BK) {
    for (int i = tid; i < BM * KG; i += THREADS) {
      const int rr = i / KG, kg = i % KG;
      const int gm = m0 + rr;
      gs[rr][kg] = pack4(g + (size_t)gm * Dout, k0 + 4 * kg, Dout, gm < T);
    }
    for (int i = tid; i < BN * KG; i += THREADS) {
      const int cc = i / KG, kg = i % KG;
      const int gn = n0 + cc;
      ws[kg][cc] = pack4(w + (size_t)gn * Dout, k0 + 4 * kg, Dout, gn < Din);
    }
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < KG; ++kg) acc = __dp4a(gs[r][kg], ws[kg][c], acc);
    __syncthreads();
  }
  epilogue(__fmul_rn((float)acc, scale[0]), z, out, m0 + r, n0 + c, T, Din,
           bg, act);
}

dim3 grid_for(int T, int Din) {
  return dim3((Din + BN - 1) / BN, (T + BM - 1) / BM);
}

}  // namespace

extern "C" int bp_gstep_emulate(const float* g, const float* w,
                                const float* z, float* out, int T, int Din,
                                int Dout, int g_on, int g_i, int g_f, int act,
                                cudaStream_t stream) {
  if (T <= 0 || Din <= 0) return 0;
  gstep_emulate_kernel<<<grid_for(T, Din), THREADS, 0, stream>>>(
      g, w, z, out, T, Din, Dout, make_bits(g_on, g_i, g_f), act);
  return (int)cudaGetLastError();
}

extern "C" int bp_gstep_int8(const void* g, const void* w, const float* scale,
                             const float* z, float* out, int T, int Din,
                             int Dout, int g_on, int g_i, int g_f, int act,
                             cudaStream_t stream) {
  if (T <= 0 || Din <= 0) return 0;
  gstep_int8_kernel<<<grid_for(T, Din), THREADS, 0, stream>>>(
      static_cast<const int8_t*>(g), static_cast<const int8_t*>(w), scale, z,
      out, T, Din, Dout, make_bits(g_on, g_i, g_f), act);
  return (int)cudaGetLastError();
}
