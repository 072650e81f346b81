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
// What bounds it on this card: on the LeNet path T = 128, so each weight
// takes 128 multiply-adds while its f32 master is read once and written
// once (8 bytes): about 2·T / 8 = 32 operations per byte.  At the f32 rate
// of the CUDA cores (67 TFLOP/s over 3.35 TB/s, 20 operations per byte)
// the emulate step is bound by its operations, just; the int8 step, at
// the int8 rate, is bound by the bytes of W.
//
// What the design does about that: dW never reaches device memory.  One
// CTA per 16x16 tile of W accumulates its dW over all tokens in registers
// (one weight per thread) and folds it into the update in the epilogue, so
// W is read once and W_new written once.  The token axis walks through
// shared memory in 64-deep tiles of X[t, i-tile] and G[t, j-tile], each
// row of a tile a contiguous 64-byte segment.  The int8 path packs 4
// consecutive tokens per 32-bit word and multiplies with __dp4a into an
// exact int32 accumulator, then rescales once.  The update keeps the
// reference's rounding: lr · dW rounds, then the subtraction rounds
// (__fmul_rn / __fsub_rn, so nvcc cannot contract them into an FMA), then
// kq_w with rintf (round half to even).  lr comes from device memory when
// the caller passes a tensor, else by value, so the step needs no host
// sync.  Ragged edges (Dout = 10 at the head, Din = 784 at the input) are
// masked.  Simple and right first: no TMA, wgmma or pipelining yet.
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;              // Din rows (i) per CTA
constexpr int BN = 16;              // Dout columns (j) per CTA
constexpr int BK = 64;              // tokens per tile
constexpr int KG = BK / 4;          // packed int8 words per tile column
constexpr int THREADS = BM * BN;    // one weight per thread

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

// kq_w(W − lr·dW), or kq_w(dW) without W, in the reference's rounding order.
__device__ __forceinline__ void epilogue(float dw, const float* __restrict__ w,
                                         const float* __restrict__ lr_ptr,
                                         float lr_val, float* __restrict__ out,
                                         int gi, int gj, int Din, int Dout,
                                         const Bits& bw) {
  if (gi >= Din || gj >= Dout) return;
  const size_t idx = (size_t)gi * Dout + gj;
  float v = dw;
  if (w != nullptr) {
    const float lr = lr_ptr != nullptr ? lr_ptr[0] : lr_val;
    v = __fsub_rn(w[idx], __fmul_rn(lr, dw));
  }
  out[idx] = kq(v, bw);
}

__global__ void __launch_bounds__(THREADS)
sgd_dw_emulate_kernel(const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ w, const float* __restrict__ lr_ptr,
    float lr_val, float* __restrict__ out, int T, int Din, int Dout, Bits bw) {
  __shared__ float xs[BK][BM];
  __shared__ float gs[BK][BN];
  const int tid = threadIdx.x;
  const int r = tid / BN, c = tid % BN;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  float acc = 0.0f;
  for (int t0 = 0; t0 < T; t0 += BK) {
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int kk = e / BM, rr = e % BM;
      const int gt = t0 + kk, gi = i0 + rr;
      xs[kk][rr] = (gt < T && gi < Din) ? x[(size_t)gt * Din + gi] : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, cc = e % BN;
      const int gt = t0 + kk, gj = j0 + cc;
      gs[kk][cc] = (gt < T && gj < Dout) ? g[(size_t)gt * Dout + gj] : 0.0f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) acc = fmaf(xs[kk][r], gs[kk][c], acc);
    __syncthreads();
  }
  epilogue(acc, w, lr_ptr, lr_val, out, i0 + r, j0 + c, Din, Dout, bw);
}

// 4 consecutive tokens t..t+3 of column `col` of a row-major [T, ld] int8
// matrix, packed little-endian into one word (zero past T or past ld).
__device__ __forceinline__ int pack_col4(const int8_t* __restrict__ p, int t,
                                         int T, int col, int ld) {
  unsigned packed = 0;
  if (col < ld) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned v = (t + j < T) ? (uint8_t)p[(size_t)(t + j) * ld + col]
                                     : 0u;
      packed |= v << (8 * j);
    }
  }
  return (int)packed;
}

__global__ void __launch_bounds__(THREADS)
sgd_dw_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ g,
    const float* __restrict__ scale, const float* __restrict__ w,
    const float* __restrict__ lr_ptr, float lr_val, float* __restrict__ out,
    int T, int Din, int Dout, Bits bw) {
  __shared__ int xs[KG][BM];
  __shared__ int gs[KG][BN];
  const int tid = threadIdx.x;
  const int r = tid / BN, c = tid % BN;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  int acc = 0;
  for (int t0 = 0; t0 < T; t0 += BK) {
    for (int e = tid; e < KG * BM; e += THREADS) {
      const int kg = e / BM, rr = e % BM;
      xs[kg][rr] = pack_col4(x, t0 + 4 * kg, T, i0 + rr, Din);
    }
    for (int e = tid; e < KG * BN; e += THREADS) {
      const int kg = e / BN, cc = e % BN;
      gs[kg][cc] = pack_col4(g, t0 + 4 * kg, T, j0 + cc, Dout);
    }
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < KG; ++kg) acc = __dp4a(xs[kg][r], gs[kg][c], acc);
    __syncthreads();
  }
  epilogue(__fmul_rn((float)acc, scale[0]), w, lr_ptr, lr_val, out, i0 + r,
           j0 + c, Din, Dout, bw);
}

dim3 grid_for(int Din, int Dout) {
  return dim3((Dout + BN - 1) / BN, (Din + BM - 1) / BM);
}

}  // namespace

extern "C" int sgd_dw_update_emulate(const float* x, const float* g,
                                     const float* w, const float* lr_ptr,
                                     float lr_val, float* out, int T, int Din,
                                     int Dout, int w_on, int w_i, int w_f,
                                     cudaStream_t stream) {
  if (Din <= 0 || Dout <= 0) return 0;
  sgd_dw_emulate_kernel<<<grid_for(Din, Dout), THREADS, 0, stream>>>(
      x, g, w, lr_ptr, lr_val, out, T, Din, Dout, make_bits(w_on, w_i, w_f));
  return (int)cudaGetLastError();
}

extern "C" int sgd_dw_update_int8(const void* x, const void* g,
                                  const float* scale, const float* w,
                                  const float* lr_ptr, float lr_val,
                                  float* out, int T, int Din, int Dout,
                                  int w_on, int w_i, int w_f,
                                  cudaStream_t stream) {
  if (Din <= 0 || Dout <= 0) return 0;
  sgd_dw_int8_kernel<<<grid_for(Din, Dout), THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(g), scale, w,
      lr_ptr, lr_val, out, T, Din, Dout, make_bits(w_on, w_i, w_f));
  return (int)cudaGetLastError();
}
