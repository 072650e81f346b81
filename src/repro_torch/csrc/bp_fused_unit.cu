// bp_fused_unit: the paper's whole TDM frame in one launch, for Hopper
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
// ~1 MB of operands and results, ~32 operations per byte: in f32 on the
// CUDA cores it is bound by its operations (0.5 us at 67 TFLOP/s); in int8
// by its bytes.  The TPU kernel kept all of W and the dW accumulator
// resident for the whole frame; at 256x256 that is 256 KiB of f32 W plus
// 256 KiB of dW, against 227 KiB of shared memory per SM.
//
// What the design does about that: the grid is split over Din row tiles
// (ROADMAP B.4).  Each CTA holds q_w(W)[tile, :] and dW[tile, :] for its
// 16 rows in shared memory and streams 16-token blocks of G [bt, Dout],
// X[:, tile] and Z[:, tile].  G_out[:, tile] contracts over the full Dout
// held by the CTA and dW[tile, :] over the tokens, so neither output needs
// a reduction across CTAs, and dW never reaches device memory.  16 rows
// give 16 CTAs at Din = 256: few for 132 SMs, and the inner loops read
// both operands from shared memory, one output per thread; register tiling,
// wgmma and TMA are for a later PR.  The absmax of W is a whole-tensor
// value that no row tile sees alone: a small reduction kernel, launched by
// the same entry point on the same stream, writes partial maxima of |W| to
// device scratch, and each CTA finishes the max from them, so s_w never
// visits the host.  Rounding follows the reference: s_w = am > 0 ?
// am / 127 : 1 (a division, not a reciprocal), payloads by rintf (round
// half to even), and every product and difference that the reference
// rounds separately is written with __fmul_rn / __fsub_rn so that nvcc
// cannot contract it into an FMA.  Ragged edges are masked.
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 16;                // Din rows per CTA
constexpr int BT = 16;                // tokens per streamed block
constexpr int TW = BT / 4;            // packed token words per column
constexpr int THREADS = BT * RT;      // one G_out element per thread
constexpr int NPART = 64;             // partial maxima of |W|
constexpr int MAX_DOUT = 1024;        // fits 227 KB of shared memory
constexpr size_t SMEM_MAX = 232448;

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

size_t emulate_smem(int Dout) {
  return sizeof(float) * ((size_t)RT * (Dout + 1) + (size_t)RT * Dout +
                          (size_t)BT * (Dout + 1) + 2 * BT * RT);
}

__global__ void __launch_bounds__(THREADS)
fused_unit_emulate_kernel(const float* __restrict__ g,
    const float* __restrict__ w, const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ lr_ptr,
    float lr_val, float* __restrict__ gout, float* __restrict__ wout, int T,
    int Din, int Dout, Bits bg, Bits bwq, Bits bwo, int act) {
  extern __shared__ float smem[];
  const int LD = Dout + 1;             // padded rows: no bank conflicts
  float* wq = smem;                    // [RT][LD]  kq_w(W) of the tile
  float* dw = wq + RT * LD;            // [RT][Dout] dW accumulator
  float* gb = dw + RT * Dout;          // [BT][LD]  G token block
  float* xb = gb + BT * LD;            // [BT][RT]  X[:, tile]
  float* zb = xb + BT * RT;            // [BT][RT]  Z[:, tile]
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * RT;
  const int nw = RT * Dout;
  for (int e = tid; e < nw; e += THREADS) {
    const int i = e / Dout, o = e % Dout, gi = i0 + i;
    wq[i * LD + o] = gi < Din ? kq(w[(size_t)gi * Dout + o], bwq) : 0.0f;
    dw[e] = 0.0f;
  }
  const int bt = tid / RT, bi = tid % RT;   // this thread's G_out element
  for (int t0 = 0; t0 < T; t0 += BT) {
    __syncthreads();                       // the previous block is consumed
    for (int e = tid; e < BT * Dout; e += THREADS) {
      const int t = e / Dout, o = e % Dout;
      gb[t * LD + o] = t0 + t < T ? g[(size_t)(t0 + t) * Dout + o] : 0.0f;
    }
    {
      const bool ok = t0 + bt < T && i0 + bi < Din;
      const size_t idx = (size_t)(t0 + bt) * Din + i0 + bi;
      xb[tid] = ok ? x[idx] : 0.0f;
      zb[tid] = ok ? z[idx] : 0.0f;
    }
    __syncthreads();
    // Eq. 8 over the full Dout held by the CTA
    {
      const float* grow = gb + bt * LD;
      const float* wrow = wq + bi * LD;
      float acc = 0.0f;
      for (int o = 0; o < Dout; ++o) acc = fmaf(grow[o], wrow[o], acc);
      if (t0 + bt < T && i0 + bi < Din)
        gout[(size_t)(t0 + bt) * Din + i0 + bi] =
            kq(__fmul_rn(acc, act_deriv(zb[tid], act)), bg);
    }
    // Eq. 9, token by token in order; each thread owns its dW elements
    for (int e = tid; e < nw; e += THREADS) {
      const int i = e / Dout, o = e % Dout;
      float s = dw[e];
#pragma unroll
      for (int t = 0; t < BT; ++t)
        s = fmaf(xb[t * RT + i], gb[t * LD + o], s);
      dw[e] = s;
    }
  }
  // Eq. 1 (each thread reads back only the dW elements it wrote)
  const float lr = lr_ptr != nullptr ? lr_ptr[0] : lr_val;
  for (int e = tid; e < nw; e += THREADS) {
    const int i = e / Dout, o = e % Dout, gi = i0 + i;
    if (gi < Din) {
      const size_t idx = (size_t)gi * Dout + o;
      wout[idx] = kq(__fsub_rn(w[idx], __fmul_rn(lr, dw[e])), bwo);
    }
  }
}

// ---------------------------------------------------------------------------
// int8 datapath
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// partial[b] = max |w| over a grid-stride share of W (max is exact, so the
// order of the reduction does not matter).
__global__ void __launch_bounds__(256)
fused_unit_absmax_kernel(const float* __restrict__ w, size_t n,
                      float* __restrict__ partial) {
  __shared__ float red[8];
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

size_t int8_smem(int Dout) {
  const size_t kw = (Dout + 3) / 4;
  return sizeof(int) * (RT * (kw + 1) + (size_t)RT * Dout + BT * (kw + 1) +
                        (size_t)Dout * (TW + 1) + RT * (TW + 1) + BT * RT + 1);
}

struct Int8Args {
  const int8_t* g;          // [T, Dout] payload
  const float* w;           // [Din, Dout] f32 master
  const int8_t* x;          // [T, Din] payload
  const float* z;           // [T, Din]
  const float* g_scale;     // s_g (device scalar)
  const float* x_scale;     // s_x (device scalar)
  const float* lr_ptr;      // lr on the device, or null: lr_val
  float lr_val;
  const float* partial;     // partial maxima of |W| (absmax mode)
  int npart;                // 0: exact (I,F) grid (w_scale, w_qmin, w_qmax)
  float w_scale, w_qmin, w_qmax;
  float* gout;              // [T, Din]
  float* wout;              // [Din, Dout]
  int T, Din, Dout, act;
  Bits bg, bwo;
};

__global__ void __launch_bounds__(THREADS) fused_unit_int8_kernel(Int8Args a) {
  extern __shared__ int ismem[];
  const int Dout = a.Dout, Din = a.Din, T = a.T;
  const int KW = (Dout + 3) / 4, LK = KW + 1, LT = TW + 1;
  int* wq = ismem;                     // [RT][LK]   q_w(W) packed along o
  int* dw = wq + RT * LK;              // [RT][Dout] int32 dW accumulator
  int* gw = dw + RT * Dout;            // [BT][LK]   G block packed along o
  int* gt = gw + BT * LK;              // [Dout][LT] G block packed along t
  int* xt = gt + Dout * LT;            // [RT][LT]   X[:, tile] along t
  float* zb = (float*)(xt + RT * LT);  // [BT][RT]
  float* sw_s = zb + BT * RT;          // s_w
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * RT;

  if (tid == 0) {
    float s_w = a.w_scale;
    if (a.npart > 0) {
      float am = 0.0f;
      for (int p = 0; p < a.npart; ++p) am = fmaxf(am, a.partial[p]);
      s_w = am > 0.0f ? am / 127.0f : 1.0f;
    }
    sw_s[0] = s_w;
  }
  __syncthreads();
  const float s_w = sw_s[0];
  const float qmin = a.npart > 0 ? -127.0f : a.w_qmin;
  const float qmax = a.npart > 0 ? 127.0f : a.w_qmax;
  for (int e = tid; e < RT * KW; e += THREADS) {
    const int i = e / KW, kg = e % KW, gi = i0 + i;
    unsigned packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = 4 * kg + j;
      int q = 0;
      if (gi < Din && o < Dout) {
        const float v = a.w[(size_t)gi * Dout + o];
        q = (int)fminf(fmaxf(rintf(v / s_w), qmin), qmax);
      }
      packed |= (unsigned)(uint8_t)(int8_t)q << (8 * j);
    }
    wq[i * LK + kg] = (int)packed;
  }
  for (int e = tid; e < RT * Dout; e += THREADS) dw[e] = 0;

  const float gsw = __fmul_rn(a.g_scale[0], s_w);         // s_g · s_w
  const int bt = tid / RT, bi = tid % RT;
  for (int t0 = 0; t0 < T; t0 += BT) {
    __syncthreads();
    for (int e = tid; e < BT * KW; e += THREADS) {          // G along o
      const int t = e / KW, kg = e % KW;
      unsigned packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = 4 * kg + j;
        const unsigned v = (t0 + t < T && o < Dout)
            ? (uint8_t)a.g[(size_t)(t0 + t) * Dout + o] : 0u;
        packed |= v << (8 * j);
      }
      gw[t * LK + kg] = (int)packed;
    }
    for (int e = tid; e < TW * Dout; e += THREADS) {        // G along t
      const int tg = e / Dout, o = e % Dout;
      unsigned packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 4 * tg + j;
        const unsigned v = t < T ? (uint8_t)a.g[(size_t)t * Dout + o] : 0u;
        packed |= v << (8 * j);
      }
      gt[o * LT + tg] = (int)packed;
    }
    for (int e = tid; e < TW * RT; e += THREADS) {          // X along t
      const int tg = e / RT, i = e % RT, gi = i0 + i;
      unsigned packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 4 * tg + j;
        const unsigned v = (t < T && gi < Din)
            ? (uint8_t)a.x[(size_t)t * Din + gi] : 0u;
        packed |= v << (8 * j);
      }
      xt[i * LT + tg] = (int)packed;
    }
    {
      const bool ok = t0 + bt < T && i0 + bi < Din;
      zb[tid] = ok ? a.z[(size_t)(t0 + bt) * Din + i0 + bi] : 0.0f;
    }
    __syncthreads();
    // Eq. 8
    {
      const int* grow = gw + bt * LK;
      const int* wrow = wq + bi * LK;
      int acc = 0;
      for (int kg = 0; kg < KW; ++kg) acc = __dp4a(grow[kg], wrow[kg], acc);
      if (t0 + bt < T && i0 + bi < Din) {
        const float y = __fmul_rn((float)acc, gsw);
        a.gout[(size_t)(t0 + bt) * Din + i0 + bi] =
            kq(__fmul_rn(y, act_deriv(zb[tid], a.act)), a.bg);
      }
    }
    // Eq. 9
    for (int e = tid; e < RT * Dout; e += THREADS) {
      const int i = e / Dout, o = e % Dout;
      int s = dw[e];
#pragma unroll
      for (int tg = 0; tg < TW; ++tg)
        s = __dp4a(xt[i * LT + tg], gt[o * LT + tg], s);
      dw[e] = s;
    }
  }
  // Eq. 1
  const float dws = __fmul_rn(a.x_scale[0], a.g_scale[0]);  // s_x · s_g
  const float lr = a.lr_ptr != nullptr ? a.lr_ptr[0] : a.lr_val;
  for (int e = tid; e < RT * Dout; e += THREADS) {
    const int i = e / Dout, o = e % Dout, gi = i0 + i;
    if (gi < Din) {
      const size_t idx = (size_t)gi * Dout + o;
      const float d = __fmul_rn((float)dw[e], dws);
      a.wout[idx] = kq(__fsub_rn(a.w[idx], __fmul_rn(lr, d)), a.bwo);
    }
  }
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

}  // namespace

extern "C" int bp_fused_unit_emulate(
    const float* g, const float* w, const float* x, const float* z,
    const float* lr_ptr, float lr_val, float* gout, float* wout, int T,
    int Din, int Dout, int g_on, int g_i, int g_f, int wq_on, int wq_i,
    int wq_f, int wo_on, int wo_i, int wo_f, int act, cudaStream_t stream) {
  if (Din <= 0 || Dout <= 0) return 0;
  if (Dout > MAX_DOUT) return (int)cudaErrorInvalidValue;
  const size_t smem = emulate_smem(Dout);
  int e = set_smem(fused_unit_emulate_kernel, smem);
  if (e != 0) return e;
  fused_unit_emulate_kernel<<<(Din + RT - 1) / RT, THREADS, smem, stream>>>(
      g, w, x, z, lr_ptr, lr_val, gout, wout, T, Din, Dout,
      make_bits(g_on, g_i, g_f), make_bits(wq_on, wq_i, wq_f),
      make_bits(wo_on, wo_i, wo_f), act);
  return (int)cudaGetLastError();
}

// w_exact = 1: W on its (I,F)-derived int8 grid (w_scale, w_qmin, w_qmax);
// w_exact = 0: whole-tensor absmax of W, reduced into `partial` (NPART
// floats of device scratch) by a first launch on the same stream.
extern "C" int bp_fused_unit_int8(
    const void* g, const float* w, const void* x, const float* z,
    const float* g_scale, const float* x_scale, const float* lr_ptr,
    float lr_val, float* partial, int w_exact, float w_scale, int w_qmin,
    int w_qmax, float* gout, float* wout, int T, int Din, int Dout, int g_on,
    int g_i, int g_f, int wo_on, int wo_i, int wo_f, int act,
    cudaStream_t stream) {
  if (Din <= 0 || Dout <= 0) return 0;
  if (Dout > MAX_DOUT) return (int)cudaErrorInvalidValue;
  const size_t smem = int8_smem(Dout);
  int e = set_smem(fused_unit_int8_kernel, smem);
  if (e != 0) return e;
  Int8Args a;
  a.g = static_cast<const int8_t*>(g);
  a.w = w;
  a.x = static_cast<const int8_t*>(x);
  a.z = z;
  a.g_scale = g_scale;
  a.x_scale = x_scale;
  a.lr_ptr = lr_ptr;
  a.lr_val = lr_val;
  a.partial = partial;
  a.npart = 0;
  a.w_scale = w_scale;
  a.w_qmin = (float)w_qmin;
  a.w_qmax = (float)w_qmax;
  a.gout = gout;
  a.wout = wout;
  a.T = T; a.Din = Din; a.Dout = Dout; a.act = act;
  a.bg = make_bits(g_on, g_i, g_f);
  a.bwo = make_bits(wo_on, wo_i, wo_f);
  if (!w_exact) {
    const size_t n = (size_t)Din * Dout;
    size_t nb = (n + 255) / 256;
    a.npart = (int)(nb < (size_t)NPART ? nb : (size_t)NPART);
    fused_unit_absmax_kernel<<<a.npart, 256, 0, stream>>>(w, n, partial);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  fused_unit_int8_kernel<<<(Din + RT - 1) / RT, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
