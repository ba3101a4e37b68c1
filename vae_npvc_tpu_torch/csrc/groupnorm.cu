// GroupNorm (+ optional tanh*sigmoid GLU) forward over (B, T, C) with
// per-row valid lengths, for Hopper (sm_90a).
//
// Replaces: vae_npvc_tpu/ops/groupnorm_pallas.py `_call_fwd` / `_fwd_kernel`
// (the TPU kernel), extended with the masked statistics of
// vae_npvc_tpu/nn/blocks.py `group_norm(..., mask=...)`: only frames
// t < lengths[b] enter the moments, the output is multiplied by the mask.
//
// Bound on the H100: bytes. The work is a few flops per element, so the
// least time is one read of x plus one write of the output over HBM
// (3.35 TB/s). The TPU kernel held a whole (T, C) row in VMEM; a Hopper
// block cannot (a flagship (256, 1024) bf16 row is 512 KB), so the row is
// split over time chunks:
//   1. gn_partial: one block per (time chunk, batch row, group) computes the
//      chunk's valid count, mean and centered sum of squares (two passes
//      over the chunk; the second pass hits L1/L2, not HBM).
//   2. gn_apply: one block per (4 frames, batch row) merges the partials
//      of its row in a fixed order (Chan's parallel merge: same moments as
//      the two-pass form up to rounding, deterministic, no atomics), then
//      normalizes, applies the affine, rounds to the storage type, masks
//      and applies the GLU.
// HBM traffic is two reads of x and one write of the output.
//
// C interface (loaded with ctypes): gn_forward returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerChunk = 8;   // frames per statistics chunk
constexpr int kApplyRows = 4;      // frames per normalize block
constexpr int kMaxGroups = 32;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round to the storage type and back: the compute-dtype cast points of the
// reference (nn/blocks.py group_norm casts before the mask and the GLU)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// deterministic block sum: fixed xor-shuffle tree per warp, then warp
// totals added in warp order by thread 0; result broadcast to all threads
__device__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) sh[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += sh[i];
    sh[32] = t;
  }
  __syncthreads();
  return sh[32];
}

__device__ __forceinline__ int valid_len(const int* lengths, int b, int T) {
  if (lengths == nullptr) return T;
  return min(max(lengths[b], 0), T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_partial(const T* __restrict__ x, const int* __restrict__ lengths, int T_,
           int C, int G, int n_chunks, float* __restrict__ part) {
  __shared__ float sh[33];
  const int chunk = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int Cg = C / G;
  const int len = valid_len(lengths, b, T_);
  const int t0 = chunk * kRowsPerChunk;
  const int rows = max(min(t0 + kRowsPerChunk, len) - t0, 0);
  const T* base = x + ((long long)b * T_ + t0) * C + (long long)g * Cg;
  const float n = (float)rows * (float)Cg;

  float s = 0.f;
  for (int r = 0; r < rows; ++r)
    for (int c = threadIdx.x; c < Cg; c += blockDim.x)
      s += to_f<T>(base[(long long)r * C + c]);
  s = block_sum(s, sh);
  const float mean = rows > 0 ? s / n : 0.f;

  float q = 0.f;
  for (int r = 0; r < rows; ++r)
    for (int c = threadIdx.x; c < Cg; c += blockDim.x) {
      const float d = to_f<T>(base[(long long)r * C + c]) - mean;
      q += d * d;
    }
  q = block_sum(q, sh);
  if (threadIdx.x == 0) {
    float* p = part + (((long long)b * G + g) * n_chunks + chunk) * 3;
    p[0] = n;
    p[1] = mean;
    p[2] = q;
  }
}

template <typename T, bool GLU>
__global__ void __launch_bounds__(kThreads)
gn_apply(const T* __restrict__ x, const float* __restrict__ scale,
         const float* __restrict__ bias, const int* __restrict__ lengths,
         const float* __restrict__ part, int T_, int C, int G, int n_chunks,
         float eps, T* __restrict__ out) {
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups];
  const int b = blockIdx.y;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float* p = part + ((long long)b * G + g) * n_chunks * 3;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = 0; k < n_chunks; ++k) {
      const float nb = p[3 * k];
      if (nb == 0.f) continue;
      const float nt = n + nb;
      const float delta = p[3 * k + 1] - mean;
      mean += delta * (nb / nt);
      m2 += p[3 * k + 2] + delta * delta * (n * nb / nt);
      n = nt;
    }
    const float cnt = fmaxf(n, 1.f);
    const float var = fmaxf(m2 / cnt, 0.f);
    s_mean[g] = mean;
    s_rstd[g] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();

  const int Cg = C / G;
  const int len = valid_len(lengths, b, T_);
  const int t0 = blockIdx.x * kApplyRows;
  const int t1 = min(t0 + kApplyRows, T_);
  const int Cout = GLU ? C / 2 : C;
  for (int t = t0; t < t1; ++t) {
    const T* xr = x + ((long long)b * T_ + t) * C;
    T* orow = out + ((long long)b * T_ + t) * Cout;
    const float m = t < len ? 1.f : 0.f;
    for (int c = threadIdx.x; c < Cout; c += blockDim.x) {
      const int ga = c / Cg;
      const float xa = __fmul_rn(to_f<T>(xr[c]) - s_mean[ga], s_rstd[ga]);
      const float ya = rnd<T>(__fadd_rn(__fmul_rn(xa, scale[c]), bias[c])) * m;
      if (GLU) {
        const int cb = c + Cout;
        const int gb = cb / Cg;
        const float xb = __fmul_rn(to_f<T>(xr[cb]) - s_mean[gb], s_rstd[gb]);
        const float yb = rnd<T>(__fadd_rn(__fmul_rn(xb, scale[cb]), bias[cb])) * m;
        const float ta = rnd<T>(tanhf(ya));
        const float sb = rnd<T>(1.f / (1.f + expf(-yb)));
        orow[c] = from_f<T>(ta * sb);
      } else {
        orow[c] = from_f<T>(ya);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const float* scale, const float* bias,
            const int* lengths, void* out, float* part, int B, int T_, int C,
            int G, int glu, float eps, cudaStream_t stream) {
  const int n_chunks = (T_ + kRowsPerChunk - 1) / kRowsPerChunk;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  gn_partial<T><<<dim3(n_chunks, B, G), kThreads, 0, stream>>>(
      xt, lengths, T_, C, G, n_chunks, part);
  const dim3 grid((T_ + kApplyRows - 1) / kApplyRows, B);
  if (glu)
    gn_apply<T, true><<<grid, kThreads, 0, stream>>>(
        xt, scale, bias, lengths, part, T_, C, G, n_chunks, eps, ot);
  else
    gn_apply<T, false><<<grid, kThreads, 0, stream>>>(
        xt, scale, bias, lengths, part, T_, C, G, n_chunks, eps, ot);
}

}  // namespace

extern "C" {

// Scratch size in floats the caller allocates for `part`.
int gn_scratch_floats(int B, int T_, int G) {
  return B * G * ((T_ + kRowsPerChunk - 1) / kRowsPerChunk) * 3;
}

int gn_max_groups() { return kMaxGroups; }

// x, out: (B, T, C) / (B, T, C or C/2) contiguous, fp32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1); scale, bias: (C,) fp32; lengths: (B,) int32 or null.
int gn_forward(const void* x, const float* scale, const float* bias,
               const int* lengths, void* out, float* part, int B, int T_,
               int C, int G, int glu, int is_bf16, float eps, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, scale, bias, lengths, out, part, B, T_, C, G, glu,
                          eps, s);
  else
    launch<float>(x, scale, bias, lengths, out, part, B, T_, C, G, glu, eps, s);
  return (int)cudaGetLastError();
}

const char* gn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
