// fxp_matmul: fixed-point (I,F) matmul + fused activation, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fxp_matmul.py::fxp_matmul, the Pallas TPU
// kernel bodies _kernel (emulate) and _kernel_int8 (int8 MXU datapath).
//
//   emulate: Y = kq_out(act(kq_a(X) @ kq_w(W)))   X, W f32 or bf16, f32 MACs
//   int8:    Y = kq_out(act(scale * int32(Xq @ Wq)))   exact int32 accumulation
//
// What bounds it on this card: on the serving path M is the decode slot
// count (1..8), so each weight element is used by at most 8 rows: the
// product reads all of W once and does 2*M operations per weight element,
// far below the ~300 operations per byte where H100's arithmetic becomes the
// limit.  It is bound by the bytes of W (4 per element for f32 masters, 1
// for int8 payloads).
//
// What the design does about that: a small M tile (8 rows) and a narrow N
// tile (32 columns) give one CTA per 8x32 output tile, so N is spread over
// the SMs (88 CTAs at N = 2816, 32 at N = 1024) instead of a few wide tiles.
// Each warp loads one 32-element row of the W tile, so W is read in
// coalesced rows, and every weight is read exactly once per M tile.  K walks
// through shared memory in 64-deep tiles.  The (I,F) rounding is applied as
// operands load (rintf: round half to even, like jnp.round; never roundf).
// The int8 path packs 4 consecutive k values per 32-bit word in shared
// memory and multiplies with __dp4a into an exact int32 accumulator, then
// rescales once in the epilogue.  Ragged edges are masked (zero fill), so
// no dimension has to divide a tile.  Simple and right first: no TMA,
// wgmma or software pipelining yet.
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;
constexpr int BN = 32;
constexpr int BK = 64;
constexpr int THREADS = BM * BN;  // one output element per thread

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

__device__ __forceinline__ float act_fn(float z, int act) {
  switch (act) {
    case 1: return fmaxf(z, 0.0f);
    case 2: return 1.0f / (1.0f + expf(-z));
    case 3: return tanhf(z);
    case 4: return z / (1.0f + expf(-z));
    case 5: {
      float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
      return 0.5f * z * (1.0f + tanhf(u));
    }
    default: return z;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
fxp_emulate_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   float* __restrict__ y, int M, int N, int K, Bits bx,
                   Bits bw, Bits bo, int act) {
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int r = tid / BN, c = tid % BN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int rr = i / BK, kk = i % BK;
      const int gm = m0 + rr, gk = k0 + kk;
      xs[rr][kk] = (gm < M && gk < K)
                       ? kq(to_f(x[(size_t)gm * K + gk]), bx) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, cc = i % BN;
      const int gk = k0 + kk, gn = n0 + cc;
      ws[kk][cc] = (gk < K && gn < N)
                       ? kq(to_f(w[(size_t)gk * N + gn]), bw) : 0.0f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) acc = fmaf(xs[r][kk], ws[kk][c], acc);
    __syncthreads();
  }
  const int gm = m0 + r, gn = n0 + c;
  if (gm < M && gn < N) y[(size_t)gm * N + gn] = kq(act_fn(acc, act), bo);
}

__global__ void __launch_bounds__(THREADS)
fxp_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ y, int M,
                int N, int K, Bits bo, int act) {
  constexpr int KG = BK / 4;  // packed words per tile row
  __shared__ int xs[BM][KG];
  __shared__ int ws[KG][BN];
  const int tid = threadIdx.x;
  const int r = tid / BN, c = tid % BN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * KG; i += THREADS) {
      const int rr = i / KG, kg = i % KG;
      const int gm = m0 + rr;
      unsigned packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + 4 * kg + j;
        const unsigned v = (gm < M && gk < K)
                               ? (uint8_t)x[(size_t)gm * K + gk] : 0u;
        packed |= v << (8 * j);
      }
      xs[rr][kg] = (int)packed;
    }
    for (int i = tid; i < KG * BN; i += THREADS) {
      const int kg = i / BN, cc = i % BN;
      const int gn = n0 + cc;
      unsigned packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + 4 * kg + j;
        const unsigned v = (gk < K && gn < N)
                               ? (uint8_t)w[(size_t)gk * N + gn] : 0u;
        packed |= v << (8 * j);
      }
      ws[kg][cc] = (int)packed;
    }
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < KG; ++kg) acc = __dp4a(xs[r][kg], ws[kg][c], acc);
    __syncthreads();
  }
  const int gm = m0 + r, gn = n0 + c;
  if (gm < M && gn < N) {
    const float z = (float)acc * scale[0];
    y[(size_t)gm * N + gn] = kq(act_fn(z, act), bo);
  }
}

template <typename TX, typename TW>
void launch_emulate(const void* x, const void* w, float* y, int M, int N,
                    int K, Bits bx, Bits bw, Bits bo, int act,
                    cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fxp_emulate_kernel<TX, TW><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), y, M, N, K, bx,
      bw, bo, act);
}

}  // namespace

extern "C" int fxp_matmul_emulate(const void* x, const void* w, float* y,
                                  int M, int N, int K, int x_bf16, int w_bf16,
                                  int xa_on, int xa_i, int xa_f, int w_on,
                                  int w_i, int w_f, int o_on, int o_i, int o_f,
                                  int act, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  const Bits bx = make_bits(xa_on, xa_i, xa_f);
  const Bits bw = make_bits(w_on, w_i, w_f);
  const Bits bo = make_bits(o_on, o_i, o_f);
  typedef __nv_bfloat16 bf16;
  if (x_bf16 && w_bf16)
    launch_emulate<bf16, bf16>(x, w, y, M, N, K, bx, bw, bo, act, stream);
  else if (x_bf16)
    launch_emulate<bf16, float>(x, w, y, M, N, K, bx, bw, bo, act, stream);
  else if (w_bf16)
    launch_emulate<float, bf16>(x, w, y, M, N, K, bx, bw, bo, act, stream);
  else
    launch_emulate<float, float>(x, w, y, M, N, K, bx, bw, bo, act, stream);
  return (int)cudaGetLastError();
}

extern "C" int fxp_matmul_int8(const void* x, const void* w,
                               const float* scale, float* y, int M, int N,
                               int K, int o_on, int o_i, int o_f, int act,
                               cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fxp_int8_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, y,
      M, N, K, make_bits(o_on, o_i, o_f), act);
  return (int)cudaGetLastError();
}
