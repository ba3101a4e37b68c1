// GroupNorm (+ optional tanh*sigmoid GLU) forward and backward over
// (B, T, C) with per-row valid lengths, for Hopper (sm_90a).
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
// Backward (gn_backward). Replaces: vae_npvc_tpu/ops/groupnorm_pallas.py
// `_call_bwd` / `_bwd_kernel`, with the same per-row lengths as the forward.
// It recomputes the group statistics from x (nothing but x, scale and bias
// is saved by the forward), rebuilds y = xhat*scale + bias in fp32 without
// rounding it, turns the GLU's (T, C/2) cotangent into dy = [g*sig*(1 -
// tanh^2), g*tanh*sig*(1 - sig)], and returns
//   dscale = sum dy*xhat, dbias = sum dy            (fp32, over valid frames)
//   dx = (dxhat - mean(dxhat) - xhat*mean(dxhat*xhat)) * rstd, dxhat = dy*scale
// with dx zero at t >= lengths[b]. Bound on the H100: bytes (one read of x
// and of g, one write of dx). The three reductions are coupled, and a row
// does not fit a block, so the work is cut into passes:
//   1. gn_partial + the fixed-order merge: the forward's statistics code.
//   2. gn_bwd_partial: one block per (32 frames, batch row) forms dy and
//      sums dy*xhat and dy per channel over its frames.
//   3. gn_bwd_rowsum: one block per batch row adds the chunk partials in
//      order into per-row channel sums, and takes the two group means from
//      them: sum dxhat = sum_c scale[c]*rowsum_dy[c] and sum dxhat*xhat =
//      sum_c scale[c]*rowsum_dyxhat[c], so no second pass over the data.
//   4. gn_bwd_param: adds the per-row sums over the batch in order.
//   5. gn_bwd_dx: one block per (4 frames, batch row) recomputes dy and
//      writes dx.
// Every sum has a fixed order and no atomics, so two runs give the same
// bits. HBM traffic is three reads of x, two of g and one write of dx.
//
// C interface (loaded with ctypes): gn_forward and gn_backward return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerChunk = 8;   // frames per statistics chunk
constexpr int kApplyRows = 4;      // frames per normalize block
constexpr int kBwdRows = 32;       // frames per backward partial block
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

// Fixed-order (Chan) merge of one batch row's chunk partials into per-group
// mean and 1/sqrt(var + eps) in shared memory; ends with a block barrier.
__device__ void merge_stats(const float* __restrict__ part, int b, int G,
                            int n_chunks, float eps, float* s_mean,
                            float* s_rstd) {
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
}

template <typename T, bool GLU>
__global__ void __launch_bounds__(kThreads)
gn_apply(const T* __restrict__ x, const float* __restrict__ scale,
         const float* __restrict__ bias, const int* __restrict__ lengths,
         const float* __restrict__ part, int T_, int C, int G, int n_chunks,
         float eps, T* __restrict__ out) {
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups];
  const int b = blockIdx.y;
  merge_stats(part, b, G, n_chunks, eps, s_mean, s_rstd);

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

// ---------------------------------------------------------------- backward

// dy of one output channel c (and, with GLU, of its gate partner c + C/2)
// at one frame, with xhat of both; y is rebuilt in fp32 and not rounded.
template <typename T, bool GLU>
__device__ __forceinline__ void dy_at(
    const T* __restrict__ xr, const T* __restrict__ gr,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* s_mean, const float* s_rstd, int c, int Cout, int Cg,
    float& xa, float& xb, float& dya, float& dyb) {
  const int ga = c / Cg;
  xa = __fmul_rn(to_f<T>(xr[c]) - s_mean[ga], s_rstd[ga]);
  const float go = to_f<T>(gr[c]);
  if (GLU) {
    const int cb = c + Cout;
    const int gb = cb / Cg;
    xb = __fmul_rn(to_f<T>(xr[cb]) - s_mean[gb], s_rstd[gb]);
    const float ya = __fadd_rn(__fmul_rn(xa, scale[c]), bias[c]);
    const float yb = __fadd_rn(__fmul_rn(xb, scale[cb]), bias[cb]);
    const float ta = tanhf(ya);
    const float sb = 1.f / (1.f + expf(-yb));
    dya = go * sb * (1.f - ta * ta);
    dyb = go * ta * sb * (1.f - sb);
  } else {
    xb = 0.f;
    dya = go;
    dyb = 0.f;
  }
}

template <typename T, bool GLU>
__global__ void __launch_bounds__(kThreads)
gn_bwd_partial(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const T* __restrict__ g,
               const int* __restrict__ lengths, const float* __restrict__ part,
               int T_, int C, int G, int n_chunks, int n_bchunks, float eps,
               float* __restrict__ pdg, float* __restrict__ pdb) {
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups];
  const int chunk = blockIdx.x, b = blockIdx.y;
  merge_stats(part, b, G, n_chunks, eps, s_mean, s_rstd);
  const int Cg = C / G;
  const int Cout = GLU ? C / 2 : C;
  const int len = valid_len(lengths, b, T_);
  const int t0 = chunk * kBwdRows;
  const int t1 = min(t0 + kBwdRows, len);
  float* og = pdg + ((long long)b * n_bchunks + chunk) * C;
  float* ob = pdb + ((long long)b * n_bchunks + chunk) * C;
  for (int c = threadIdx.x; c < Cout; c += blockDim.x) {
    float ga = 0.f, ba = 0.f, gb = 0.f, bb = 0.f;
    for (int t = t0; t < t1; ++t) {
      const T* xr = x + ((long long)b * T_ + t) * C;
      const T* gr = g + ((long long)b * T_ + t) * Cout;
      float xa, xb, dya, dyb;
      dy_at<T, GLU>(xr, gr, scale, bias, s_mean, s_rstd, c, Cout, Cg, xa, xb,
                    dya, dyb);
      ga += dya * xa;
      ba += dya;
      gb += dyb * xb;
      bb += dyb;
    }
    og[c] = ga;
    ob[c] = ba;
    if (GLU) {
      og[c + Cout] = gb;
      ob[c + Cout] = bb;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gn_bwd_rowsum(const float* __restrict__ scale, const int* __restrict__ lengths,
              const float* __restrict__ pdg, const float* __restrict__ pdb,
              int T_, int C, int G, int n_bchunks, float* __restrict__ rdg,
              float* __restrict__ rdb, float* __restrict__ ms) {
  __shared__ float sh[33];
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sg = 0.f, sb = 0.f;
    for (int k = 0; k < n_bchunks; ++k) {
      sg += pdg[((long long)b * n_bchunks + k) * C + c];
      sb += pdb[((long long)b * n_bchunks + k) * C + c];
    }
    rdg[(long long)b * C + c] = sg;
    rdb[(long long)b * C + c] = sb;
  }
  __syncthreads();   // the row sums above are read across threads below
  const int Cg = C / G;
  const float n = fmaxf((float)valid_len(lengths, b, T_) * (float)Cg, 1.f);
  for (int g = 0; g < G; ++g) {
    float v1 = 0.f, v2 = 0.f;
    for (int c = g * Cg + threadIdx.x; c < (g + 1) * Cg; c += blockDim.x) {
      v1 += scale[c] * rdb[(long long)b * C + c];
      v2 += scale[c] * rdg[(long long)b * C + c];
    }
    v1 = block_sum(v1, sh);
    v2 = block_sum(v2, sh);
    if (threadIdx.x == 0) {
      ms[((long long)b * G + g) * 2] = v1 / n;
      ms[((long long)b * G + g) * 2 + 1] = v2 / n;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gn_bwd_param(const float* __restrict__ rdg, const float* __restrict__ rdb,
             int B, int C, float* __restrict__ dscale,
             float* __restrict__ dbias) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int b = 0; b < B; ++b) {
    sg += rdg[(long long)b * C + c];
    sb += rdb[(long long)b * C + c];
  }
  dscale[c] = sg;
  dbias[c] = sb;
}

template <typename T, bool GLU>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx(const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, const T* __restrict__ g,
          const int* __restrict__ lengths, const float* __restrict__ part,
          const float* __restrict__ ms, int T_, int C, int G, int n_chunks,
          float eps, T* __restrict__ dx) {
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups];
  __shared__ float s_m1[kMaxGroups], s_m2[kMaxGroups];
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < G; k += blockDim.x) {
    s_m1[k] = ms[((long long)b * G + k) * 2];
    s_m2[k] = ms[((long long)b * G + k) * 2 + 1];
  }
  merge_stats(part, b, G, n_chunks, eps, s_mean, s_rstd);
  const int Cg = C / G;
  const int Cout = GLU ? C / 2 : C;
  const int len = valid_len(lengths, b, T_);
  const int t0 = blockIdx.x * kApplyRows;
  const int t1 = min(t0 + kApplyRows, T_);
  for (int t = t0; t < t1; ++t) {
    const T* xr = x + ((long long)b * T_ + t) * C;
    const T* gr = g + ((long long)b * T_ + t) * Cout;
    T* dr = dx + ((long long)b * T_ + t) * C;
    if (t >= len) {
      for (int c = threadIdx.x; c < C; c += blockDim.x) dr[c] = from_f<T>(0.f);
      continue;
    }
    for (int c = threadIdx.x; c < Cout; c += blockDim.x) {
      float xa, xb, dya, dyb;
      dy_at<T, GLU>(xr, gr, scale, bias, s_mean, s_rstd, c, Cout, Cg, xa, xb,
                    dya, dyb);
      const int ga = c / Cg;
      dr[c] = from_f<T>(
          (dya * scale[c] - s_m1[ga] - xa * s_m2[ga]) * s_rstd[ga]);
      if (GLU) {
        const int cb = c + Cout;
        const int gb = cb / Cg;
        dr[cb] = from_f<T>(
            (dyb * scale[cb] - s_m1[gb] - xb * s_m2[gb]) * s_rstd[gb]);
      }
    }
  }
}

// offsets (in floats) of the backward's scratch regions in one allocation
struct BwdScratch {
  long long part, pdg, pdb, rdg, rdb, ms, total;
};

BwdScratch bwd_scratch(int B, int T_, int C, int G) {
  const long long n_chunks = (T_ + kRowsPerChunk - 1) / kRowsPerChunk;
  const long long n_bchunks = (T_ + kBwdRows - 1) / kBwdRows;
  BwdScratch s;
  s.part = 0;
  s.pdg = s.part + (long long)B * G * n_chunks * 3;
  s.pdb = s.pdg + (long long)B * n_bchunks * C;
  s.rdg = s.pdb + (long long)B * n_bchunks * C;
  s.rdb = s.rdg + (long long)B * C;
  s.ms = s.rdb + (long long)B * C;
  s.total = s.ms + (long long)B * G * 2;
  return s;
}

template <typename T>
void launch_bwd(const void* x, const float* scale, const float* bias,
                const void* g, const int* lengths, void* dx, float* dscale,
                float* dbias, float* scratch, int B, int T_, int C, int G,
                int glu, float eps, cudaStream_t stream) {
  const int n_chunks = (T_ + kRowsPerChunk - 1) / kRowsPerChunk;
  const int n_bchunks = (T_ + kBwdRows - 1) / kBwdRows;
  const BwdScratch o = bwd_scratch(B, T_, C, G);
  struct { float *part, *pdg, *pdb, *rdg, *rdb, *ms; } s = {
      scratch + o.part, scratch + o.pdg, scratch + o.pdb,
      scratch + o.rdg, scratch + o.rdb, scratch + o.ms};
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  gn_partial<T><<<dim3(n_chunks, B, G), kThreads, 0, stream>>>(
      xt, lengths, T_, C, G, n_chunks, s.part);
  const dim3 pgrid(n_bchunks, B);
  if (glu)
    gn_bwd_partial<T, true><<<pgrid, kThreads, 0, stream>>>(
        xt, scale, bias, gt, lengths, s.part, T_, C, G, n_chunks, n_bchunks,
        eps, s.pdg, s.pdb);
  else
    gn_bwd_partial<T, false><<<pgrid, kThreads, 0, stream>>>(
        xt, scale, bias, gt, lengths, s.part, T_, C, G, n_chunks, n_bchunks,
        eps, s.pdg, s.pdb);
  gn_bwd_rowsum<<<B, kThreads, 0, stream>>>(
      scale, lengths, s.pdg, s.pdb, T_, C, G, n_bchunks, s.rdg, s.rdb, s.ms);
  gn_bwd_param<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      s.rdg, s.rdb, B, C, dscale, dbias);
  const dim3 grid((T_ + kApplyRows - 1) / kApplyRows, B);
  if (glu)
    gn_bwd_dx<T, true><<<grid, kThreads, 0, stream>>>(
        xt, scale, bias, gt, lengths, s.part, s.ms, T_, C, G, n_chunks, eps,
        dt);
  else
    gn_bwd_dx<T, false><<<grid, kThreads, 0, stream>>>(
        xt, scale, bias, gt, lengths, s.part, s.ms, T_, C, G, n_chunks, eps,
        dt);
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

// Scratch size in floats the caller allocates for gn_backward.
long long gn_bwd_scratch_floats(int B, int T_, int C, int G) {
  return bwd_scratch(B, T_, C, G).total;
}

// x, dx: (B, T, C); g: (B, T, C or C/2) contiguous, all fp32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1); scale, bias, dscale, dbias: (C,) fp32; lengths:
// (B,) int32 or null.
int gn_backward(const void* x, const float* scale, const float* bias,
                const void* g, const int* lengths, void* dx, float* dscale,
                float* dbias, float* scratch, int B, int T_, int C, int G,
                int glu, int is_bf16, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(x, scale, bias, g, lengths, dx, dscale, dbias,
                              scratch, B, T_, C, G, glu, eps, s);
  else
    launch_bwd<float>(x, scale, bias, g, lengths, dx, dscale, dbias, scratch,
                      B, T_, C, G, glu, eps, s);
  return (int)cudaGetLastError();
}

const char* gn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
