// Fused vector-quantization pass for Hopper (sm_90a): nearest code ids,
// gathered code rows and, optionally, the per-code cluster statistics of
// the EMA codebook update.
//
// Replaces: vae_npvc_tpu/ops/vq_pallas.py `vq_fused` / `_vq_kernel`.
//
// Bound on the H100: operations. dist = ||e||^2 - 2 z.e^T is 2*N*K*D fp32
// operations against (N + K)*D*4 bytes; at K = 512, D = 128 that is 256
// flops per byte, so at 67 TFLOP/s (fp32 outside the tensor cores) the
// products bound it, not HBM. The products stay in true fp32 FMA (TF32
// keeps ~10 mantissa bits and flips near-tie argmins against the
// reference). Design:
//   - vq_argmin: a block takes 64 rows of z into shared memory and streams
//     its share of the codebook through shared memory in 64-code chunks
//     (the fp32 codebook, 256 KB at the flagship, does not fit the 227 KB
//     a block may use). ||e||^2 is computed once per chunk. Each thread
//     keeps a 4x4 tile of dot products and a running (best_dist, best_idx)
//     per row, visiting codes in increasing order, so a tie keeps the lower
//     index, as jnp.argmin does. Rows >= N read as zero and are never
//     written: no padding copy.
//   - the codebook is split over gridDim.y when there are too few row
//     tiles to give every SM two blocks (serving: N = 8*256 rows is 32
//     tiles for 132 SMs). vq_pick then takes, per row, the best of the
//     splits in split order (lower codes first, strict <: ties still keep
//     the lower index) and gathers z_q, a copy of codebook rows (exactly
//     the one-hot fp32 product of the TPU kernel).
//   - stats mode: the grid has no sequential carry, and fp32 atomics would
//     make the sums depend on scheduling. vq_stats_partial sums rows into
//     per-(segment, code) partials, each warp in its own shared-memory
//     accumulator in row order; vq_stats_reduce adds the 16 segments in
//     order. Runs are deterministic, and the scratch is 16*K*(D+1) floats
//     (4 MB at K = 512, D = 128) whatever N is.
//
// C interface (loaded with ctypes): vq_fused_launch returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // z rows per block
constexpr int kCodes = 64;     // codebook rows per shared-memory chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 4 rows x 4 codes each
constexpr int kSegments = 16;  // row segments of the stats pass
constexpr int kStatWarps = 8;
constexpr int kIdxPiece = 1024;
constexpr int kStatSmemBudget = 200 * 1024;

size_t argmin_smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kRows + kCodes) * (D + 1) + kCodes);
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    n = 1;
  return n;
}

// codebook splits: enough (row tile, split) blocks for two per SM, at
// most one 64-code chunk per split
int num_splits(int N, int K, int device) {
  const int tiles = (N + kRows - 1) / kRows;
  const int chunks = (K + kCodes - 1) / kCodes;
  int s = (2 * sm_count(device) + tiles - 1) / tiles;
  return s < 1 ? 1 : (s > chunks ? chunks : s);
}

int stat_codes_per_block(int D) {
  const int avail = kStatSmemBudget - (int)sizeof(int) * kIdxPiece;
  int c = avail / (kStatWarps * ((int)sizeof(float) * D + (int)sizeof(int)));
  return c < 1 ? 1 : (c > 32 ? 32 : c);
}

size_t stats_smem_bytes(int D, int cpb) {
  return sizeof(float) * (size_t)kStatWarps * cpb * D +
         sizeof(int) * ((size_t)kStatWarps * cpb + kIdxPiece);
}

__global__ void __launch_bounds__(kThreads)
vq_argmin(const float* __restrict__ z, const float* __restrict__ emb, int N,
          int K, int D, float* __restrict__ pbest, int* __restrict__ pidx) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // padded rows: conflict-free column reads
  float* zs = smem;
  float* es = zs + kRows * ld;
  float* e2 = es + kCodes * ld;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int chunks = (K + kCodes - 1) / kCodes;
  const int per_split = (chunks + gridDim.y - 1) / gridDim.y;
  const int k_begin = blockIdx.y * per_split * kCodes;
  const int k_end = min(K, k_begin + per_split * kCodes);

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const long long gr = row0 + r;
    zs[r * ld + d] = gr < N ? z[gr * D + d] : 0.f;
  }

  float best[4];
  int besti[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    besti[i] = 0;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kCodes) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kCodes * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const int gk = k0 + c;
      es[c * ld + d] = gk < K ? emb[(long long)gk * D + d] : 0.f;
    }
    __syncthreads();
    if (tid < kCodes) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) {
        const float e = es[tid * ld + d];
        s += e * e;
      }
      e2[tid] = s;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = zs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = es[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + tx + 16 * j;
      if (gk < k_end) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dist = e2[tx + 16 * j] - 2.f * acc[i][j];
          if (dist < best[i]) {
            best[i] = dist;
            besti[i] = gk;
          }
        }
      }
    }
  }

  // argmin across the 16 threads sharing a row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int o = 8; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, besti[i], o);
      if (od < best[i] || (od == best[i] && oi < besti[i])) {
        best[i] = od;
        besti[i] = oi;
      }
    }
    const long long gr = row0 + ty + 16 * i;
    if (tx == 0 && gr < N) {
      pbest[(long long)blockIdx.y * N + gr] = best[i];
      pidx[(long long)blockIdx.y * N + gr] = besti[i];
    }
  }
}

// one warp per row: best of the splits in split order, then the z_q gather
__global__ void vq_pick(const float* __restrict__ pbest,
                        const int* __restrict__ pidx,
                        const float* __restrict__ emb, int N, int D,
                        int splits, int* __restrict__ idx,
                        float* __restrict__ zq) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  float best = pbest[row];
  int bi = pidx[row];
  for (int s = 1; s < splits; ++s) {
    const float d = pbest[(long long)s * N + row];
    if (d < best) {
      best = d;
      bi = pidx[(long long)s * N + row];
    }
  }
  if (lane == 0) idx[row] = bi;
  if (zq != nullptr)
    for (int d = lane; d < D; d += 32)
      zq[row * D + d] = emb[(long long)bi * D + d];
}

__global__ void vq_stats_partial(const float* __restrict__ z,
                                 const int* __restrict__ idx, int N, int K,
                                 int D, int cpb, float* __restrict__ psum,
                                 float* __restrict__ pcnt) {
  extern __shared__ float smem[];
  float* acc = smem;                                      // warps x cpb x D
  int* wcnt = reinterpret_cast<int*>(acc + kStatWarps * cpb * D);  // warps x cpb
  int* sidx = wcnt + kStatWarps * cpb;                    // kIdxPiece
  const int seg = blockIdx.x, k0 = blockIdx.y * cpb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long seg_rows = ((long long)N + kSegments - 1) / kSegments;
  const long long r_begin = seg * seg_rows;
  const long long r_end = min((long long)N, r_begin + seg_rows);

  for (int i = threadIdx.x; i < kStatWarps * cpb * D; i += blockDim.x) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kStatWarps * cpb; i += blockDim.x) wcnt[i] = 0;
  float* wacc = acc + warp * cpb * D;
  int* wc = wcnt + warp * cpb;

  for (long long p0 = r_begin; p0 < r_end; p0 += kIdxPiece) {
    const int np = (int)min((long long)kIdxPiece, r_end - p0);
    __syncthreads();
    for (int i = threadIdx.x; i < np; i += blockDim.x) sidx[i] = idx[p0 + i];
    __syncthreads();
    for (int i = warp; i < np; i += kStatWarps) {
      const int c = sidx[i] - k0;
      if (c < 0 || c >= cpb) continue;  // uniform across the warp
      const float* zr = z + (p0 + i) * D;
      float* a = wacc + c * D;
      for (int d = lane; d < D; d += 32) a[d] += zr[d];
      if (lane == 0) wc[c] += 1;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cpb * D; i += blockDim.x) {
    const int c = i / D;
    if (k0 + c >= K) continue;
    float s = 0.f;
    for (int w = 0; w < kStatWarps; ++w) s += acc[w * cpb * D + i];
    psum[((long long)seg * K + k0) * D + i] = s;
  }
  for (int c = threadIdx.x; c < cpb; c += blockDim.x) {
    if (k0 + c >= K) continue;
    int s = 0;
    for (int w = 0; w < kStatWarps; ++w) s += wcnt[w * cpb + c];
    pcnt[(long long)seg * K + k0 + c] = (float)s;
  }
}

__global__ void vq_stats_reduce(const float* __restrict__ psum,
                                const float* __restrict__ pcnt, int K, int D,
                                float* __restrict__ bsum,
                                float* __restrict__ belem) {
  const int k = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < kSegments; ++g) s += psum[((long long)g * K + k) * D + d];
    bsum[(long long)k * D + d] = s;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int g = 0; g < kSegments; ++g) s += pcnt[(long long)g * K + k];
    belem[k] = s;
  }
}

}  // namespace

extern "C" {

// Scratch sizes in 4-byte words the caller allocates: `pbest` and `pidx`
// (each), `psum`, `pcnt`.
int vq_scratch_argmin_words(int N, int K, int device) {
  return num_splits(N, K, device) * N;
}
int vq_scratch_sum_floats(int K, int D) { return kSegments * K * D; }
int vq_scratch_cnt_floats(int K) { return kSegments * K; }

// Largest D whose tiles fit a block's shared memory.
int vq_max_dim() {
  int d = 1;
  while (argmin_smem_bytes(d + 1) <= 227 * 1024) ++d;
  return d;
}

// z (N, D), emb (K, D) fp32 contiguous -> idx (N,) int32; zq (N, D) fp32
// when non-null; with psum non-null also bsum (K, D) and belem (K,) over
// the N rows. pbest/pidx, psum/pcnt are scratch.
int vq_fused_launch(const float* z, const float* emb, int N, int K, int D,
                    int* idx, float* zq, float* pbest, int* pidx, float* psum,
                    float* pcnt, float* bsum, float* belem, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = argmin_smem_bytes(D);
  err = cudaFuncSetAttribute(vq_argmin,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int splits = num_splits(N, K, device);
  vq_argmin<<<dim3((N + kRows - 1) / kRows, splits), kThreads, smem, s>>>(
      z, emb, N, K, D, pbest, pidx);
  vq_pick<<<(N + 7) / 8, 256, 0, s>>>(pbest, pidx, emb, N, D, splits, idx, zq);
  if (psum != nullptr) {
    const int cpb = stat_codes_per_block(D);
    const size_t ssmem = stats_smem_bytes(D, cpb);
    err = cudaFuncSetAttribute(vq_stats_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ssmem);
    if (err != cudaSuccess) return (int)err;
    vq_stats_partial<<<dim3(kSegments, (K + cpb - 1) / cpb), kStatWarps * 32,
                       ssmem, s>>>(z, idx, N, K, D, cpb, psum, pcnt);
    vq_stats_reduce<<<K, 128, 0, s>>>(psum, pcnt, K, D, bsum, belem);
  }
  return (int)cudaGetLastError();
}

const char* vq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
