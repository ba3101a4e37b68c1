// Masked multi-head self-attention, forward and backward, for Hopper
// (sm_90a): o = softmax(q k^T * scale + key-padding mask) v over
// (B, H, T, d) with one shared T and per-batch-row valid key counts.
//
// Replaces: vae_npvc_tpu/ops/attention_pallas.py `_fwd` / `_fwd_kernel`
// (attn_forward) and `_bwd` / `_bwd_kernel` (attn_backward), the TPU kernels
// behind `fused_attention`.
//
// Contract kept from the TPU kernels (its rounding points, not its blocks):
//   - products take operands in the input type (fp32 or bf16; a bf16 value
//     is exact in fp32, so bf16 operands are widened in shared memory and
//     multiplied with fp32 FMAs: the same products, fp32 accumulation, no
//     TF32); the scale is applied to the fp32 scores;
//   - masking, max-subtraction, exp, the denominator and the log-sum-exp are
//     fp32; keys at positions >= lengths[b] score -FLT_MAX (finite), with
//     the all-masked guard m = max(m, -FLT_MAX/2); lengths are clamped to
//     [1, T]; queries are not masked;
//   - p is rounded to the input type before p v and p^T dO, ds before ds k
//     and ds^T q; o is divided by max(denominator, 1e-30) in fp32, then cast;
//   - the forward saves o and the fp32 log-sum-exp (B*H, T); the backward
//     recomputes p = exp(s - lse) and never stores a (T, T) array.
//
// Bound on the H100: operations. One forward is 4*B*H*T*Tk*d flops (Tk the
// valid keys), the backward 10*B*H*T*Tk*d; the bytes (q, k, v, o once) are
// two orders of magnitude below at the model's shapes. In fp32, the
// recipe's type, the limit is the 67 TFLOP/s FMA rate; in bf16 it would be
// the tensor cores, which this first version does not use (wgmma and TMA
// are later work), so bf16 runs at the fp32 kernel's speed.
//
// Design. The TPU kernel keeps a whole (T, 128) key row in VMEM and takes the
// softmax in one pass; a (64, 768) fp32 score tile alone is 196 KB here. So:
//   - attn_fwd_kernel: one block per (64 queries, batch*head) loops over
//     64-key tiles with a running maximum and sum (online softmax); the
//     result equals the one-pass form up to fp32 summation order. Key tiles
//     beyond lengths[b] are skipped: their p is exactly 0.
//   - The TPU backward accumulates dk/dv in scratch across sequential grid
//     steps; CUDA blocks have no order, so the backward is two kernels with
//     fixed summation orders and no atomics (two runs give the same bits):
//     attn_bwd_dq_kernel, one block per query tile looping over key tiles,
//     also writes D = rowsum(dO*o); attn_bwd_dkdv_kernel, one block per key
//     tile looping over every query tile, reads D.
//   - 256 threads as 16 x 16; a thread owns a 4 x 4 piece of each 64 x 64
//     score tile (rows 4*ty.., columns tx + 16*j, so shared-memory reads of
//     the key rows are conflict-free with a row stride of d + 4 floats) and
//     4 rows x (2 columns every 32) of the (64, d) accumulators. Tiles are
//     read from global memory 16 bytes (fp32) or 8 bytes (bf16) a thread.
//   - Tensors are read by stride (last dimension contiguous): the (B, H, T,
//     d) views of a (B, T, H*d) projection need no copy, and d = 96 is taken
//     as it is (any d <= 128 with d % 8 == 0), with ragged T masked here.
//
// C interface (loaded with ctypes): attn_forward and attn_backward return
// cudaGetLastError(). Strides are in elements, three per tensor (batch,
// head, time), as one host array.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // queries per block and keys per step
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kLdP = kTile + kPad;
constexpr int kMaxHeadDim = 128;

struct View {        // one (B, H, T, d) tensor, last dimension contiguous
  char* ptr;
  long long sb, sh, st;   // strides in elements
};

struct Params {
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;           // (B*H, T)
  float* delta;         // (B*H, T), backward only
  const int* lengths;   // (B,) or null
  int B, H, T, d;
  float scale;
  int bf16;
};

__device__ __forceinline__ const char* head_base(const View& t, int b, int h,
                                                 int esize) {
  return t.ptr + ((long long)b * t.sb + (long long)h * t.sh) * esize;
}

__device__ __forceinline__ float round_to_input(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// The scaled score, rounded to fp32 before anything is subtracted from it:
// left to the compiler, the backward's s * scale - lse becomes one FMA that
// keeps the product unrounded, and then differs from the forward's rounded
// score by up to half an ulp of it, which is 1e9 for scores of 1e16.
__device__ __forceinline__ float score(float s, float scale) {
  return __fmul_rn(s, scale);
}

// Rows [r0, r0 + 64) x d of one head into shared memory as fp32, row stride
// ld; rows >= rmax are zero.
__device__ __forceinline__ void load_tile(float* dst, int ld, const char* base,
                                          long long st, int r0, int rmax,
                                          int d, bool bf16) {
  const int nchunk = d >> 2;
  for (int idx = threadIdx.x; idx < kTile * nchunk; idx += kThreads) {
    const int r = idx / nchunk;
    const int c = (idx - r * nchunk) << 2;
    const int row = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rmax) {
      const long long off = (long long)row * st + c;
      if (bf16) {
        const uint2 raw = *reinterpret_cast<const uint2*>(base + off * 2);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        val = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        val = *reinterpret_cast<const float4*>(base + off * 4);
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// acc[i][j] += sum_k A[4*ty + i][k] * B[tx + 16*j][k], k < d.
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A,
                                      const float* B, int ld, int d, int ty,
                                      int tx) {
  const float* a0 = A + (ty * 4) * ld;
  const float* b0 = B + tx * ld;
#pragma unroll 2
  for (int kk = 0; kk < d; kk += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(a0 + i * ld + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(b0 + (16 * j) * ld + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][jj][e] += sum_n P[4*ty + i][n] * V[n][2*tx + 32*jj + e], n < 64; P
// has row stride kLdP, V row stride ld; columns >= d are left alone.
template <int NJ2>
__device__ __forceinline__ void mm_nn(float (&acc)[4][NJ2][2], const float* P,
                                      const float* V, int ld, int d, int ty,
                                      int tx) {
  const float* p0 = P + (ty * 4) * kLdP;
  for (int n = 0; n < kTile; n += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(p0 + i * kLdP + n);
      pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
    }
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int jj = 0; jj < NJ2; ++jj) {
        const int c = 2 * tx + 32 * jj;
        if (c < d) {
          const float2 v =
              *reinterpret_cast<const float2*>(V + (n + nn) * ld + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj][0] = fmaf(pv[i][nn], v.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(pv[i][nn], v.y, acc[i][jj][1]);
          }
        }
      }
  }
}

// Rows r0 + 4*ty + i < rmax of acc (divided by den[i] when DIV) to global
// memory in the input type.
template <int NJ2, bool DIV>
__device__ __forceinline__ void store_rows(const View& t, int b, int h,
                                           int r0, int rmax, int d, bool bf16,
                                           const float (&acc)[4][NJ2][2],
                                           const float (&den)[4], int ty,
                                           int tx) {
  char* base = const_cast<char*>(head_base(t, b, h, bf16 ? 2 : 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= rmax) continue;
#pragma unroll
    for (int jj = 0; jj < NJ2; ++jj) {
      const int c = 2 * tx + 32 * jj;
      if (c >= d) continue;
      float x = acc[i][jj][0], y = acc[i][jj][1];
      if (DIV) { x = x / den[i]; y = y / den[i]; }
      const long long off = (long long)row * t.st + c;
      if (bf16)
        *reinterpret_cast<__nv_bfloat162*>(base + off * 2) =
            __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(base + off * 4) = make_float2(x, y);
    }
  }
}

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  if (p.lengths == nullptr) return p.T;
  return min(max(p.lengths[b], 1), p.T);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------------------------ forward
template <int NJ2>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int d = p.d, ld = d + kPad, T = p.T;
  const bool bf16 = p.bf16 != 0;
  const int es = bf16 ? 2 : 4;
  float* Qs = smem;
  float* Ks = Qs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ps = Vs + kTile * ld;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int len = valid_keys(p, b);
  const char* kb = head_base(p.k, b, h, es);
  const char* vb = head_base(p.v, b, h, es);

  load_tile(Qs, ld, head_base(p.q, b, h, es), p.q.st, q0, T, d, bf16);

  float m[4], l[4], acc[4][NJ2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ2; ++jj) acc[i][jj][0] = acc[i][jj][1] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += kTile) {
    __syncthreads();   // the previous step's reads of Ks, Vs, Ps are done
    load_tile(Ks, ld, kb, p.k.st, k0, len, d, bf16);
    load_tile(Vs, ld, vb, p.v.st, k0, len, d, bf16);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mm_nt(s, Qs, Ks, ld, d, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = col < len ? score(s[i][j], p.scale) : -FLT_MAX;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = half_warp_max(mt);
      const float mn = fmaxf(fmaxf(m[i], mt), -FLT_MAX * 0.5f);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = expf(s[i][j] - mn);
        rs += pe;
        Ps[(ty * 4 + i) * kLdP + tx + 16 * j] = round_to_input(pe, bf16);
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < NJ2; ++jj) {
        acc[i][jj][0] *= alpha;
        acc[i][jj][1] *= alpha;
      }
    }
    __syncthreads();
    mm_nn<NJ2>(acc, Ps, Vs, ld, d, ty, tx);
  }

  float den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    den[i] = fmaxf(l[i], 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < T)
      p.lse[(long long)bh * T + row] = m[i] + logf(den[i]);
  }
  store_rows<NJ2, true>(p.o, b, h, q0, T, d, bf16, acc, den, ty, tx);
}

// ------------------------------------------------- backward: dq and D rows
template <int NJ2>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int d = p.d, ld = d + kPad, T = p.T;
  const bool bf16 = p.bf16 != 0;
  const int es = bf16 ? 2 : 4;
  float* Qs = smem;
  float* Gs = Qs + kTile * ld;    // dO rows
  float* Ks = Gs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ps = Vs + kTile * ld;
  float* Ls = Ps + kTile * kLdP;  // lse rows
  float* Ds = Ls + kTile;         // D rows
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int len = valid_keys(p, b);
  const char* kb = head_base(p.k, b, h, es);
  const char* vb = head_base(p.v, b, h, es);

  load_tile(Qs, ld, head_base(p.q, b, h, es), p.q.st, q0, T, d, bf16);
  load_tile(Gs, ld, head_base(p.dout, b, h, es), p.dout.st, q0, T, d, bf16);
  load_tile(Ks, ld, head_base(p.o, b, h, es), p.o.st, q0, T, d, bf16);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    Ls[threadIdx.x] = row < T ? p.lse[(long long)bh * T + row] : 0.f;
  }
  __syncthreads();
  {
    // D = rowsum(dO * o): four neighbouring lanes per row
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float sum = 0.f;
    for (int c = part; c < d; c += 4) sum += Gs[r * ld + c] * Ks[r * ld + c];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      Ds[r] = sum;
      if (q0 + r < T) p.delta[(long long)bh * T + q0 + r] = sum;
    }
  }

  float acc[4][NJ2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ2; ++jj) acc[i][jj][0] = acc[i][jj][1] = 0.f;

  for (int k0 = 0; k0 < len; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, ld, kb, p.k.st, k0, len, d, bf16);
    load_tile(Vs, ld, vb, p.v.st, k0, len, d, bf16);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt(s, Qs, Ks, ld, d, ty, tx);
    mm_nt(dp, Gs, Vs, ld, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lse = Ls[ty * 4 + i], dr = Ds[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float pe =
            col < len ? expf(score(s[i][j], p.scale) - lse) : 0.f;
        const float ds = pe * (dp[i][j] - dr) * p.scale;
        Ps[(ty * 4 + i) * kLdP + tx + 16 * j] = round_to_input(ds, bf16);
      }
    }
    __syncthreads();
    mm_nn<NJ2>(acc, Ps, Ks, ld, d, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<NJ2, false>(p.dq, b, h, q0, T, d, bf16, acc, one, ty, tx);
}

// ---------------------------------------------------- backward: dk and dv
template <int NJ2>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int d = p.d, ld = d + kPad, T = p.T;
  const bool bf16 = p.bf16 != 0;
  const int es = bf16 ? 2 : 4;
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* Gs = Qs + kTile * ld;
  float* Pt = Gs + kTile * ld;       // p transposed: [key][query]
  float* St = Pt + kTile * kLdP;     // ds transposed
  float* Ls = St + kTile * kLdP;
  float* Ds = Ls + kTile;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int len = valid_keys(p, b);

  float dk[4][NJ2][2], dv[4][NJ2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ2; ++jj)
      dk[i][jj][0] = dk[i][jj][1] = dv[i][jj][0] = dv[i][jj][1] = 0.f;
  const float one[4] = {1.f, 1.f, 1.f, 1.f};

  if (k0 < len) {   // a tile of masked keys keeps its zeros
    const char* qb = head_base(p.q, b, h, es);
    const char* gb = head_base(p.dout, b, h, es);
    load_tile(Ks, ld, head_base(p.k, b, h, es), p.k.st, k0, len, d, bf16);
    load_tile(Vs, ld, head_base(p.v, b, h, es), p.v.st, k0, len, d, bf16);

    for (int q0 = 0; q0 < T; q0 += kTile) {
      __syncthreads();
      load_tile(Qs, ld, qb, p.q.st, q0, T, d, bf16);
      load_tile(Gs, ld, gb, p.dout.st, q0, T, d, bf16);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const bool in = row < T;
        Ls[threadIdx.x] = in ? p.lse[(long long)bh * T + row] : 0.f;
        Ds[threadIdx.x] = in ? p.delta[(long long)bh * T + row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      mm_nt(s, Qs, Ks, ld, d, ty, tx);
      mm_nt(dp, Gs, Vs, ld, d, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const bool kv = k0 + key < len;
        float pe[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          const float e = (kv && q0 + r < T)
                              ? expf(score(s[i][j], p.scale) - Ls[r]) : 0.f;
          pe[i] = round_to_input(e, bf16);
          ds[i] = round_to_input(e * (dp[i][j] - Ds[r]) * p.scale, bf16);
        }
        *reinterpret_cast<float4*>(Pt + key * kLdP + ty * 4) =
            make_float4(pe[0], pe[1], pe[2], pe[3]);
        *reinterpret_cast<float4*>(St + key * kLdP + ty * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      mm_nn<NJ2>(dv, Pt, Gs, ld, d, ty, tx);
      mm_nn<NJ2>(dk, St, Qs, ld, d, ty, tx);
    }
  }
  store_rows<NJ2, false>(p.dk, b, h, k0, T, d, bf16, dk, one, ty, tx);
  store_rows<NJ2, false>(p.dv, b, h, k0, T, d, bf16, dv, one, ty, tx);
}

size_t fwd_smem(int d) {
  return sizeof(float) * (3 * kTile * (d + kPad) + kTile * kLdP);
}
size_t dq_smem(int d) {
  return sizeof(float) * (4 * kTile * (d + kPad) + kTile * kLdP + 2 * kTile);
}
size_t dkdv_smem(int d) {
  return sizeof(float) * (4 * kTile * (d + kPad) + 2 * kTile * kLdP
                          + 2 * kTile);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kTile - 1) / kTile, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

View view(const void* ptr, const long long* s) {
  return View{static_cast<char*>(const_cast<void*>(ptr)), s[0], s[1], s[2]};
}

bool shape_ok(int B, int H, int T, int d) {
  return B > 0 && H > 0 && T > 0 && d > 0 && d <= kMaxHeadDim && d % 8 == 0
         && (long long)B * H <= 65535;
}

}  // namespace

extern "C" {

int attn_max_head_dim() { return kMaxHeadDim; }

// q, k, v, o: (B, H, T, d) fp32 (is_bf16 = 0) or bf16 (1), last dimension
// contiguous, 16-byte aligned, strides (elements; multiples of 8) in
// `strides` as q, k, v, o x (batch, head, time); lse: (B*H, T) fp32;
// lengths: (B,) int32 or null.
int attn_forward(const void* q, const void* k, const void* v, void* o,
                 float* lse, const int* lengths, const long long* strides,
                 int B, int H, int T, int d, float scale, int is_bf16,
                 int device, void* stream) {
  if (!shape_ok(B, H, T, d)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p{};
  p.q = view(q, strides);
  p.k = view(k, strides + 3);
  p.v = view(v, strides + 6);
  p.o = view(o, strides + 9);
  p.lse = lse;
  p.lengths = lengths;
  p.B = B; p.H = H; p.T = T; p.d = d;
  p.scale = scale;
  p.bf16 = is_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) err = launch(attn_fwd_kernel<2>, fwd_smem(d), p, s);
  else if (d <= 96) err = launch(attn_fwd_kernel<3>, fwd_smem(d), p, s);
  else err = launch(attn_fwd_kernel<4>, fwd_smem(d), p, s);
  return (int)err;
}

// The backward from the saved o and lse and the cotangent dout of o:
// dq, dk, dv in the input type; delta: (B*H, T) fp32 scratch. `strides`
// holds q, k, v, o, dout, dq, dk, dv x (batch, head, time).
int attn_backward(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, const int* lengths,
                  void* dq, void* dk, void* dv, float* delta,
                  const long long* strides, int B, int H, int T, int d,
                  float scale, int is_bf16, int device, void* stream) {
  if (!shape_ok(B, H, T, d)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p{};
  p.q = view(q, strides);
  p.k = view(k, strides + 3);
  p.v = view(v, strides + 6);
  p.o = view(o, strides + 9);
  p.dout = view(dout, strides + 12);
  p.dq = view(dq, strides + 15);
  p.dk = view(dk, strides + 18);
  p.dv = view(dv, strides + 21);
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.lengths = lengths;
  p.B = B; p.H = H; p.T = T; p.d = d;
  p.scale = scale;
  p.bf16 = is_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) {
    err = launch(attn_bwd_dq_kernel<2>, dq_smem(d), p, s);
    if (err == cudaSuccess)
      err = launch(attn_bwd_dkdv_kernel<2>, dkdv_smem(d), p, s);
  } else if (d <= 96) {
    err = launch(attn_bwd_dq_kernel<3>, dq_smem(d), p, s);
    if (err == cudaSuccess)
      err = launch(attn_bwd_dkdv_kernel<3>, dkdv_smem(d), p, s);
  } else {
    err = launch(attn_bwd_dq_kernel<4>, dq_smem(d), p, s);
    if (err == cudaSuccess)
      err = launch(attn_bwd_dkdv_kernel<4>, dkdv_smem(d), p, s);
  }
  return (int)err;
}

const char* attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
