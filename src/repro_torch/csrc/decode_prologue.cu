// decode_prologue: RMSNorm + Q/K/V projections (+ bias) + RoPE for one decode
// token per slot, in one launch, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_prologue.py::_call_kernel, the Pallas
// TPU kernel body _kernel running _prologue_rows (emulate: f32 master weights
// cast to the compute dtype) or _prologue_rows_int8 (int8 weights with
// per-tensor scales, per-row activation absmax, int32 MACs, one rescale).
//
// What bounds it on this card: the weights.  x is [B, D] with B = the slot
// count (8), and every weight element is used by B rows only, so the launch
// reads D * (H + 2*Hkv) * hd weights once (12.6 MB of f32 masters per layer
// at qwen1.5-0.5b width, 3.1 MB as int8) and is bound by those bytes.
//
// What the design does about that: the TPU kernel kept all three weight
// matrices resident in VMEM; they do not fit one SM's 227 KB, so here the
// grid has one CTA per output head (H + 2*Hkv CTAs, 48 at full width), each
// reading only its hd weight columns, as coalesced row segments, exactly
// once.  Each CTA recomputes the RMSNorm of the B rows in shared memory (B*D
// work, cheap next to the weights) and rounds the normed row to the compute
// dtype before the dot, where the reference rounds.  256 threads split K in
// four interleaved slices, each holding one accumulator per row; the slices
// are summed through shared memory.  The head's hd outputs stay in the CTA,
// so the half-rotation RoPE pairs (j, j + hd/2) are both local.  Rows are
// processed in chunks of at most 8 (RB) to bound shared memory.
// Results are written in the compute dtype: q [B,H,hd], k and v [B,Hkv,hd].
//
// Plain C interface (built by nvcc, loaded with ctypes).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KS = 4;        // K slices
constexpr int CT = 64;       // columns per tile (THREADS / KS)
constexpr int RB_MAX = 8;    // rows per chunk

struct Params {
  const void* x;             // [B, D] compute dtype
  const float* nscale;       // [D]
  const void* w[3];          // [D, nh*hd] f32 masters or int8 payloads
  const float* wscale;       // [3] per-tensor scales (int8 only)
  const float* bias[3];      // [nh*hd] f32 or null
  const int* pos;            // [B]
  void* out[3];              // [B, nh, hd] compute dtype
  int B, D, H, Hkv, hd, RB, use_rope;
  float theta, eps;
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

template <typename T, bool INT8>
__global__ void __launch_bounds__(THREADS) prologue_kernel(Params p) {
  extern __shared__ float smem[];
  const int RB = p.RB, D = p.D, hd = p.hd;
  float* xs = smem;                      // [RB, D] normed rows (int in INT8)
  float* red = xs + RB * D;              // [KS, RB, CT] partial sums
  float* outv = red + KS * RB * CT;      // [RB, hd] head outputs
  float* sx = outv + RB * hd;            // [RB] activation scales (INT8)
  int* xi = reinterpret_cast<int*>(xs);
  int* redi = reinterpret_cast<int*>(red);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int head = blockIdx.x, kind = 0;
  if (head >= p.H) { head -= p.H; kind = 1; }
  if (kind == 1 && head >= p.Hkv) { head -= p.Hkv; kind = 2; }
  const int nh = kind == 0 ? p.H : p.Hkv;
  const int ncols = nh * hd, cb = head * hd;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out[kind]);
  const float* bias = p.bias[kind];
  const int c = tid % CT, ks = tid / CT;

  for (int r0 = 0; r0 < p.B; r0 += RB) {
    const int rb = min(RB, p.B - r0);
    // 1. RMSNorm of each row (one warp per row), rounded to the compute
    //    dtype; the int8 path then quantizes the row by its absmax.
    for (int r = warp; r < rb; r += THREADS / 32) {
      const T* xr = x + (size_t)(r0 + r) * D;
      float ss = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float v = to_f(xr[d]);
        ss += v * v;
      }
      ss = warp_sum(ss);
      const float inv = 1.0f / sqrtf(ss / (float)D + p.eps);
      float amax = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float v = round_dt<T>(__fmul_rn(__fmul_rn(to_f(xr[d]), inv),
                                              p.nscale[d]));
        xs[r * D + d] = v;
        amax = fmaxf(amax, fabsf(v));
      }
      if (INT8) {
        amax = warp_max(amax);
        const float s = amax > 0.0f ? amax / 127.0f : 1.0f;
        for (int d = lane; d < D; d += 32) {
          const float q = fminf(fmaxf(rintf(xs[r * D + d] / s), -127.0f),
                                127.0f);
          xi[r * D + d] = (int)q;
        }
        if (lane == 0) sx[r] = s;
      }
    }
    __syncthreads();

    // 2. This head's hd columns, CT at a time: K split over KS slices.
    for (int c0 = 0; c0 < hd; c0 += CT) {
      const int col = c0 + c;
      const bool valid = col < hd;
      if (INT8) {
        const int8_t* w = static_cast<const int8_t*>(p.w[kind]);
        int acc[RB_MAX];
#pragma unroll
        for (int r = 0; r < RB_MAX; ++r) acc[r] = 0;
        for (int k = ks; k < D; k += KS) {
          const int wv = valid ? (int)w[(size_t)k * ncols + cb + col] : 0;
#pragma unroll
          for (int r = 0; r < RB_MAX; ++r)
            if (r < rb) acc[r] += xi[r * D + k] * wv;
        }
#pragma unroll
        for (int r = 0; r < RB_MAX; ++r)
          if (r < rb) redi[(ks * RB + r) * CT + c] = acc[r];
      } else {
        const float* w = static_cast<const float*>(p.w[kind]);
        float acc[RB_MAX];
#pragma unroll
        for (int r = 0; r < RB_MAX; ++r) acc[r] = 0.0f;
        for (int k = ks; k < D; k += KS) {
          const float wv =
              valid ? round_dt<T>(w[(size_t)k * ncols + cb + col]) : 0.0f;
#pragma unroll
          for (int r = 0; r < RB_MAX; ++r)
            if (r < rb) acc[r] = fmaf(xs[r * D + k], wv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RB_MAX; ++r)
          if (r < rb) red[(ks * RB + r) * CT + c] = acc[r];
      }
      __syncthreads();
      for (int i = tid; i < rb * CT; i += THREADS) {
        const int r = i / CT, cc = i % CT, cl = c0 + cc;
        if (cl >= hd) continue;
        float v;
        if (INT8) {
          int tot = 0;
          for (int s = 0; s < KS; ++s) tot += redi[(s * RB + r) * CT + cc];
          v = round_dt<T>((float)tot * (sx[r] * p.wscale[kind]));
        } else {
          float tot = 0.0f;
          for (int s = 0; s < KS; ++s) tot += red[(s * RB + r) * CT + cc];
          v = round_dt<T>(tot);
        }
        if (bias != nullptr) v = round_dt<T>(v + round_dt<T>(bias[cb + cl]));
        outv[r * hd + cl] = v;
      }
      __syncthreads();
    }

    // 3. Half-rotation RoPE on q and k (v is never rotated), then store.
    const int half = hd / 2;
    if (p.use_rope && kind < 2) {
      for (int i = tid; i < rb * half; i += THREADS) {
        const int r = i / half, j = i % half;
        const float freq = 1.0f / powf(p.theta, (float)j / (float)half);
        const float ang = (float)p.pos[r0 + r] * freq;
        const float cs = cosf(ang), sn = sinf(ang);
        const float x1 = outv[r * hd + j], x2 = outv[r * hd + j + half];
        T* o = out + ((size_t)(r0 + r) * nh + head) * hd;
        o[j] = from_f<T>(__fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)));
        o[j + half] =
            from_f<T>(__fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs)));
      }
    } else {
      for (int i = tid; i < rb * hd; i += THREADS) {
        const int r = i / hd, j = i % hd;
        out[((size_t)(r0 + r) * nh + head) * hd + j] = from_f<T>(outv[i]);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool INT8>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kern = prologue_kernel<T, INT8>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<p.H + 2 * p.Hkv, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_prologue_launch(
    const void* x, const float* nscale, const void* wq, const void* wk,
    const void* wv, const float* wscale, const float* bq, const float* bk,
    const float* bv, const int* pos, void* q, void* k, void* v, int B, int D,
    int H, int Hkv, int hd, int use_rope, float theta, float eps, int x_bf16,
    int int8, cudaStream_t stream) {
  if (B <= 0) return 0;
  Params p;
  p.x = x; p.nscale = nscale;
  p.w[0] = wq; p.w[1] = wk; p.w[2] = wv;
  p.wscale = wscale;
  p.bias[0] = bq; p.bias[1] = bk; p.bias[2] = bv;
  p.pos = pos;
  p.out[0] = q; p.out[1] = k; p.out[2] = v;
  p.B = B; p.D = D; p.H = H; p.Hkv = Hkv; p.hd = hd; p.use_rope = use_rope;
  p.theta = theta; p.eps = eps;
  // rows per chunk: as many as fit 200 KB of shared memory, at most 8
  const size_t per_row = sizeof(float) * ((size_t)D + KS * CT + hd + 1);
  int rb = B < RB_MAX ? B : RB_MAX;
  while (rb > 1 && per_row * rb > 200 * 1024) --rb;
  if (per_row * rb > 200 * 1024) return (int)cudaErrorInvalidValue;
  p.RB = rb;
  const size_t smem = per_row * rb;
  typedef __nv_bfloat16 bf16;
  if (x_bf16) return int8 ? launch<bf16, true>(p, smem, stream)
                          : launch<bf16, false>(p, smem, stream);
  return int8 ? launch<float, true>(p, smem, stream)
              : launch<float, false>(p, smem, stream);
}
