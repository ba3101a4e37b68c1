// Masked multi-head self-attention, forward and backward, for Hopper
// (sm_90a): o = softmax(q k^T * scale + key-padding mask) v over
// (B, H, T, d) with one shared T and per-batch-row valid key counts.
//
// Replaces: vae_npvc_tpu/ops/attention_pallas.py `_fwd` / `_fwd_kernel`
// (attn_forward) and `_bwd` / `_bwd_kernel` (attn_backward), the TPU kernels
// behind `fused_attention`.
//
// Contract kept from the TPU kernels (its rounding points, not its blocks):
//   - products take operands in the input type and accumulate in fp32; the
//     scale is applied to the fp32 score with __fmul_rn;
//   - masking, max-subtraction, exp, the denominator and the log-sum-exp are
//     fp32; keys at positions >= lengths[b] score -FLT_MAX (finite), with
//     the all-masked guard m = max(m, -FLT_MAX/2); lengths are clamped to
//     [1, T]; queries are not masked;
//   - p is rounded to the input type before p v and p^T dO, ds before ds k
//     and ds^T q; o is divided by max(denominator, 1e-30) in fp32, then cast;
//   - the forward saves o and the fp32 log-sum-exp (B*H, T); the backward
//     recomputes p = exp(s - lse) and never stores a (T, T) array;
//   - fixed summation orders and no atomics: two runs give the same bits.
//
// Bound on the H100: operations. One forward is 4*B*H*T*Tk*d flops (Tk the
// valid keys), the backward 10*B*H*T*Tk*d (five products; the two kernels
// below do seven); the bytes (q, k, v, o once) are two orders of magnitude
// below at the model's shapes. Every product runs on the tensor cores
// through mma.sync:
//   - bf16: m16n8k16 bf16 x bf16 -> fp32. A bf16 product is exact in fp32
//     and the sum is fp32, so this is the contract itself; bound: 989
//     TFLOP/s.
//   - fp32: 3xTF32 on m16n8k8. Each operand x is split into hi = rna_tf32(x)
//     and lo = rna_tf32(x - hi); lo*hi, then hi*lo, then hi*hi are summed
//     (small terms first), which keeps ~21 of fp32's 24 bits: o, dq, dk and
//     dv within 3e-6 to 1.1e-5 of their peak from the plain version on an
//     H100 (chip_smoke.py's cases); one TF32 product misses the 2e-5 / 3e-5
//     tolerance tenfold (tests/test_torch_port_attention_tf32x3.py). The
//     sums over key (query) tiles take each tile in a fresh fragment, added
//     rounded to nearest (mm_pn): against float64 at T = 3,072 (d = 48, 96)
//     o, dq, dk and dv stay within 1.4e-6 to 3.6e-6 of their peak, where one
//     tensor-core sum over every tile reached 3.4e-5
//     (tools/torch_attn_f64.py).
//     Bound: three TF32 products at 495 TFLOP/s, 165 TFLOP/s (2.5x the 67
//     TFLOP/s fp32 FMA rate).
//   - exp: expf in fp32; __expf (ex2.approx) in bf16, see exp_arg.
//
// Design.
//   - A (T, T) score row does not fit: the forward walks 64-key tiles with a
//     running maximum and sum (online softmax). Key tiles beyond lengths[b]
//     are skipped: their p is exactly 0. A block of 4 warps takes 64
//     queries (16 rows a warp), in fp32 128 (32 rows a warp, so each K/V
//     fragment is read and split once for two 16-row tiles) where those
//     blocks cover the SMs. One decoded utterance gives 48 blocks on 132
//     SMs; smaller blocks that fill them were slower (see forward()).
//   - Scores and p stay in registers: the m16n8 accumulator of S for 16 keys
//     is the A fragment of the next product (bf16: as it lies; fp32: with the
//     keys of each 8-key step taken in the order 0,2,4,6,1,3,5,7, which only
//     reorders the sum and makes the matching B reads conflict-free).
//   - Backward: dk/dv accumulate across sequential grid steps on the TPU;
//     here two kernels: attn_bwd_dq_kernel, one block per 64-query tile over
//     key tiles, also writes D = rowsum(dO*o); attn_bwd_dkdv_kernel, one
//     block per 64-key tile over every query tile, computes S^T = K Q^T so
//     that p^T and ds^T land in the accumulator layout of dV = P^T dO and
//     dK = dS^T Q. Its scores must equal the forward's bit for bit (else
//     exp(s - lse) overflows at scores of 1e16): the products are exact and
//     the k order is the same, and its 3xTF32 takes the cross terms in the
//     swapped operand order, so the same three partial products are summed
//     in the same order.
//   - Tiles stay in the input type in shared memory, rows padded (bf16: 8
//     elements, ldmatrix without bank conflicts on 192-byte rows; fp32: 4
//     floats, scalar fragment loads without conflicts); the head dim is
//     zero-padded to 64, 96 or 128. Rows come in by 16-byte cp.async, read by
//     stride (the (B, H, T, d) views of a (B, T, H*d) projection need no
//     copy), rows past lengths or T zero-filled; the next K (or V, Q, dO)
//     tile is in flight while the current one is multiplied.
//
// C interface (loaded with ctypes): attn_forward and attn_backward return
// cudaGetLastError(). Strides are in elements, three per tensor (batch,
// head, time), as one host array.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kTile = 64;   // keys per step; queries (keys) per backward block
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
};

template <bool BF16>
using Elem = std::conditional_t<BF16, __nv_bfloat16, float>;

// shared-memory row stride in elements (see the design note)
template <int DP, bool BF16>
__host__ __device__ constexpr int row_stride() {
  return BF16 ? DP + 8 : DP + 4;
}

__device__ __forceinline__ const char* head_base(const View& t, int b, int h,
                                                 int esize) {
  return t.ptr + ((long long)b * t.sb + (long long)h * t.sh) * esize;
}

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  if (p.lengths == nullptr) return p.T;
  return min(max(p.lengths[b], 1), p.T);
}

// ------------------------------------------------------------ async copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [r0, r0 + nrows) x [0, DP) of one head into shared memory (row
// stride LD); rows >= rmax and columns >= d are zero-filled. NTH threads.
template <int DP, bool BF16, int NTH>
__device__ __forceinline__ void load_rows(Elem<BF16>* dst, const char* base,
                                          long long st, int r0, int nrows,
                                          int rmax, int d) {
  constexpr int kLd = row_stride<DP, BF16>();
  constexpr int kChunk = 16 / sizeof(Elem<BF16>);   // elements per copy
  constexpr int kChunks = DP / kChunk;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += NTH) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * kChunk;
    const int row = r0 + r;
    const bool in = row < rmax && c < d;
    const char* src =
        in ? base + ((long long)row * st + c) * sizeof(Elem<BF16>) : base;
    cp_async16(dst + r * kLd + c, src, in ? 16 : 0);
  }
}

// ------------------------------------------------------ tensor-core tiles
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo + O(2^-22 |x|), both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// One 3xTF32 step: c += a*b from the hi/lo parts, small terms first. SWAP
// takes the cross terms in the other operand order, so that a product
// computed with A and B exchanged sums the same partial products in the
// same order (the dk/dv kernel's S^T against the forward's S).
template <bool SWAP>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  if (SWAP) {
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, al, bh0, bh1);
  } else {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

// c[m][j] (16 x 8 tiles, m < MT, j < 8) += A[16*MT x DP] * B[64 x DP]^T: A
// is the warp's 16*MT rows, B a 64-row tile, both row-major in shared
// memory. Each B fragment is loaded (and split) once for the MT row tiles.
template <int DP, bool BF16, bool SWAP, int MT>
__device__ __forceinline__ void mm_nt(float (&c)[MT][8][4],
                                      const Elem<BF16>* A,
                                      const Elem<BF16>* B, int lane) {
  constexpr int kLd = row_stride<DP, BF16>();
  if constexpr (BF16) {
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4(a[m],
                A + (m * 16 + (lane & 15)) * kLd + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, B + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk
                       + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(c[m][j], a[m], b[0], b[1]);
          mma_bf16(c[m][j + 1], a[m], b[2], b[3]);
        }
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int kk = 0; kk < DP; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* a = A + (m * 16 + g) * kLd + kk + t;
        split_tf32(a[0], ah[m][0], al[m][0]);
        split_tf32(a[8 * kLd], ah[m][1], al[m][1]);
        split_tf32(a[4], ah[m][2], al[m][2]);
        split_tf32(a[8 * kLd + 4], ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* b = B + (j * 8 + g) * kLd + kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b[0], bh0, bl0);
        split_tf32(b[4], bh1, bl1);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma_3xtf32<SWAP>(c[m][j], ah[m], al[m], bh0, bh1, bl0, bl1);
      }
    }
  }
}

template <int L, int N, int M>
__device__ __forceinline__ void zero(float (&c)[L][N][M]) {
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int k = 0; k < M; ++k) c[i][j][k] = 0.f;
}

// Columns (8-wide tiles) of the fresh fragment of mm_pn's fp32 route: the
// largest divisor of DP/8 that keeps it within 48 floats a thread (the
// running sums already hold up to 128).
template <int DP, int MT>
__host__ __device__ constexpr int fresh_cols() {
  int nc = DP / 8;
  while (MT * nc * 4 > 48 || (DP / 8) % nc) --nc;
  return nc;
}

// c[m][n] (16 x 8 tiles, m < MT, n < DP/8) += P[16*MT x 64] * B[64 x DP]:
// P is fp32 in the m16n8 accumulator layout of mm_nt, B a 64-row tile,
// row-major in shared memory. c is a running sum over the 64-row tiles of a
// whole row (o and dq over key tiles, dk and dv over query tiles). The bf16
// route packs P to bf16 here (round to nearest even): that is the contract's
// rounding of p and ds to the input type before their products; it adds
// straight into c. The fp32 route sums the tile's product in a fresh
// fragment, fresh_cols() column tiles at a time, and adds it to c with
// __fadd_rn: the tensor cores' fp32 accumulation does not round to nearest,
// so a sum carried through them over every tile lost bits in one direction
// per tile and its error grew with T (3.4e-5 of the peak at T = 3,072);
// rounded to nearest once per tile, in the same tile order every run, it
// stays at a tile's worth.
template <int DP, bool BF16, int MT>
__device__ __forceinline__ void mm_pn(float (&c)[MT][DP / 8][4],
                                      const float (&p)[MT][8][4],
                                      const Elem<BF16>* B, int lane) {
  constexpr int kLd = row_stride<DP, BF16>();
  if constexpr (BF16) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a[m][0] = pack_bf16(p[m][2 * kk][0], p[m][2 * kk][1]);
        a[m][1] = pack_bf16(p[m][2 * kk][2], p[m][2 * kk][3]);
        a[m][2] = pack_bf16(p[m][2 * kk + 1][0], p[m][2 * kk + 1][1]);
        a[m][3] = pack_bf16(p[m][2 * kk + 1][2], p[m][2 * kk + 1][3]);
      }
      const Elem<BF16>* brow =
          B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd
          + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, brow + n * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(c[m][n], a[m], b[0], b[1]);
          mma_bf16(c[m][n + 1], a[m], b[2], b[3]);
        }
      }
    }
  } else {
    constexpr int kCols = fresh_cols<DP, MT>();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += kCols) {
      float f[MT][kCols][4];
      zero(f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // k slot t is key 8j + 2t, slot t + 4 key 8j + 2t + 1
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          split_tf32(p[m][j][0], ah[m][0], al[m][0]);
          split_tf32(p[m][j][2], ah[m][1], al[m][1]);
          split_tf32(p[m][j][1], ah[m][2], al[m][2]);
          split_tf32(p[m][j][3], ah[m][3], al[m][3]);
        }
        const float* b = B + (8 * j + 2 * t) * kLd + g;
#pragma unroll
        for (int n = 0; n < kCols; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b[(n0 + n) * 8], bh0, bl0);
          split_tf32(b[kLd + (n0 + n) * 8], bh1, bl1);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            mma_3xtf32<false>(f[m][n], ah[m], al[m], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < kCols; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            c[m][n0 + n][e] = __fadd_rn(c[m][n0 + n][e], f[m][n][e]);
    }
  }
}

// Rows r0 + g (and + 8) < rmax of the warp's accumulator (divided by den
// when given) to global memory in the input type, columns < d.
template <int DP, bool BF16>
__device__ __forceinline__ void store_rows(const View& t, int b, int h,
                                           int r0, int rmax, int d,
                                           const float (&c)[DP / 8][4],
                                           const float* den, int lane) {
  char* base = const_cast<char*>(head_base(t, b, h, sizeof(Elem<BF16>)));
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= rmax) continue;
    const float dn = den ? den[half] : 1.f;   // x / 1 is exact
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col >= d) continue;
      const float x = c[n][2 * half] / dn, y = c[n][2 * half + 1] / dn;
      const long long off = (long long)row * t.st + col;
      if (BF16)
        *reinterpret_cast<__nv_bfloat162*>(base + off * 2) =
            __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(base + off * 4) = make_float2(x, y);
    }
  }
}

// exp of a score minus its row's maximum or log-sum-exp (x <= 0, or
// -FLT_MAX - m). bf16: __expf, ex2.approx of x*log2(e), two instructions
// against expf's eight and within 2 + 1.2|x| fp32 ulps, some 1e-4 of the
// bf16 ulp p is rounded to; fp32: expf. x*log2(e) is rounded after the
// subtraction, so scores of 1e16 keep their exact differences.
template <bool BF16>
__device__ __forceinline__ float exp_arg(float x) {
  return BF16 ? __expf(x) : expf(x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sets the entries of a 16 x 64 accumulator tile whose column first + col
// is >= lim to val. Only a tile that crosses lim needs it; the callers test
// that first, so full tiles skip the compares.
__device__ __forceinline__ void mask_cols(float (&c)[8][4], int first,
                                          int lim, float val, int lane) {
  const int c0 = first + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + 8 * j + (e & 1) >= lim) c[j][e] = val;
}

// ------------------------------------------------------------------ forward
// One block: 16*MT*NW queries (NW warps of 16*MT rows) of one (batch, head),
// over 64-key tiles. K and V have one buffer each: V_j arrives while
// S_j = Q K_j^T is computed, K_{j+1} while P_j V_j is.
template <int DP, int NW, int MT, bool BF16>
__global__ void __launch_bounds__(32 * NW) attn_fwd_kernel(Params p) {
  using T = Elem<BF16>;
  constexpr int kLd = row_stride<DP, BF16>(), kWarpRows = 16 * MT,
                kRows = kWarpRows * NW, kThreads = 32 * NW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kRows * kLd;
  T* Vs = Ks + kTile * kLd;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, Tn = p.T, d = p.d;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int len = valid_keys(p, b);
  const char* kb = head_base(p.k, b, h, sizeof(T));
  const char* vb = head_base(p.v, b, h, sizeof(T));

  load_rows<DP, BF16, kThreads>(Qs, head_base(p.q, b, h, sizeof(T)), p.q.st,
                                q0, kRows, Tn, d);
  load_rows<DP, BF16, kThreads>(Ks, kb, p.k.st, 0, kTile, len, d);
  cp_commit();
  load_rows<DP, BF16, kThreads>(Vs, vb, p.v.st, 0, kTile, len, d);
  cp_commit();

  const T* Qw = Qs + warp * kWarpRows * kLd;
  float m[MT][2], l[MT][2];   // per row g and g + 8 of each row tile
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = -FLT_MAX;
    l[i][0] = l[i][1] = 0.f;
  }
  float acc[MT][DP / 8][4];
  zero(acc);

  for (int k0 = 0; k0 < len; k0 += kTile) {
    const bool more = k0 + kTile < len, full = k0 + kTile <= len;
    cp_wait<1>();        // K_j (V_j may still be in flight)
    __syncthreads();
    float s[MT][8][4];
    zero(s);
    mm_nt<DP, BF16, false, MT>(s, Qw, Ks, lane);

#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = __fmul_rn(s[i][j][e], p.scale);
      if (!full) mask_cols(s[i], k0, len, -FLT_MAX, lane);
      float mt[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[i][j][e]);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn =
            fmaxf(fmaxf(m[i][r], quad_max(mt[r])), -FLT_MAX * 0.5f);
        alpha[r] = exp_arg<BF16>(m[i][r] - mn);
        m[i][r] = mn;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp_arg<BF16>(s[i][j][e] - m[i][e >> 1]);
          rs[e >> 1] += pe;
          s[i][j][e] = pe;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[i][r] = l[i][r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha[e >> 1];
    }

    __syncthreads();     // every warp is done with K_j
    if (more) {
      load_rows<DP, BF16, kThreads>(Ks, kb, p.k.st, k0 + kTile, kTile, len, d);
      cp_commit();
      cp_wait<1>();      // V_j
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    mm_pn<DP, BF16, MT>(acc, s, Vs, lane);
    __syncthreads();     // every warp is done with V_j
    if (more) {
      load_rows<DP, BF16, kThreads>(Vs, vb, p.v.st, k0 + kTile, kTile, len, d);
      cp_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float den[2];
    const int r0 = q0 + warp * kWarpRows + 16 * i;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      den[r] = fmaxf(quad_sum(l[i][r]), 1e-30f);
      const int row = r0 + g + 8 * r;
      if (tq == 0 && row < Tn)
        p.lse[(long long)bh * Tn + row] = m[i][r] + logf(den[r]);
    }
    store_rows<DP, BF16>(p.o, b, h, r0, Tn, d, acc[i], den, lane);
  }
}

// ------------------------------------------------- backward: dq and D rows
// One block: 64 queries (4 warps) of one (batch, head), over key tiles.
template <int DP, bool BF16>
__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(Params p) {
  using T = Elem<BF16>;
  constexpr int kLd = row_stride<DP, BF16>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + kTile * kLd;   // dO rows
  T* Ks = Gs + kTile * kLd;
  T* Vs = Ks + kTile * kLd;
  float* Ls = reinterpret_cast<float*>(Vs + kTile * kLd);   // lse rows
  float* Ds = Ls + kTile;                                   // D rows
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, Tn = p.T, d = p.d;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int len = valid_keys(p, b);
  const char* kb = head_base(p.k, b, h, sizeof(T));
  const char* vb = head_base(p.v, b, h, sizeof(T));

  load_rows<DP, BF16, 128>(Qs, head_base(p.q, b, h, sizeof(T)), p.q.st, q0,
                           kTile, Tn, d);
  load_rows<DP, BF16, 128>(Gs, head_base(p.dout, b, h, sizeof(T)),
                           p.dout.st, q0, kTile, Tn, d);
  load_rows<DP, BF16, 128>(Ks, head_base(p.o, b, h, sizeof(T)), p.o.st, q0,
                           kTile, Tn, d);   // o rows, for D
  cp_commit();
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    Ls[threadIdx.x] = row < Tn ? p.lse[(long long)bh * Tn + row] : 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  {
    // D = rowsum(dO * o): two neighbouring lanes per row
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
    float sum = 0.f;
    for (int c = part; c < d; c += 2)
      sum += float(Gs[r * kLd + c]) * float(Ks[r * kLd + c]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (part == 0) {
      Ds[r] = sum;
      if (q0 + r < Tn) p.delta[(long long)bh * Tn + q0 + r] = sum;
    }
  }
  __syncthreads();     // o rows read
  load_rows<DP, BF16, 128>(Ks, kb, p.k.st, 0, kTile, len, d);
  load_rows<DP, BF16, 128>(Vs, vb, p.v.st, 0, kTile, len, d);
  cp_commit();

  const T* Qw = Qs + warp * 16 * kLd;
  const T* Gw = Gs + warp * 16 * kLd;
  float acc[1][DP / 8][4];
  zero(acc);
  for (int k0 = 0; k0 < len; k0 += kTile) {
    const bool more = k0 + kTile < len;
    cp_wait<0>();
    __syncthreads();
    float s[1][8][4], dp[1][8][4];
    zero(dp);
    mm_nt<DP, BF16, false, 1>(dp, Gw, Vs, lane);
    zero(s);
    mm_nt<DP, BF16, false, 1>(s, Qw, Ks, lane);
    __syncthreads();   // every warp is done with V_j
    if (more) {
      load_rows<DP, BF16, 128>(Vs, vb, p.v.st, k0 + kTile, kTile, len, d);
      cp_commit();
    }
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[0][j][e] = exp_arg<BF16>(__fmul_rn(s[0][j][e], p.scale)
                                   - Ls[r0 + 4 * (e & 2)]);
    if (k0 + kTile > len) mask_cols(s[0], k0, len, 0.f, lane);   // p
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)   // ds
        s[0][j][e] = s[0][j][e] * (dp[0][j][e] - Ds[r0 + 4 * (e & 2)])
                     * p.scale;
    mm_pn<DP, BF16, 1>(acc, s, Ks, lane);
    __syncthreads();   // every warp is done with K_j
    if (more) {
      load_rows<DP, BF16, 128>(Ks, kb, p.k.st, k0 + kTile, kTile, len, d);
      cp_commit();
    }
  }
  store_rows<DP, BF16>(p.dq, b, h, q0 + warp * 16, Tn, d, acc[0], nullptr,
                       lane);
}

// ---------------------------------------------------- backward: dk and dv
// One block: 64 keys (4 warps of 16) of one (batch, head), over every
// 64-query tile. S^T = K Q^T puts p^T in the A layout of dV = P^T dO.
template <int DP, bool BF16>
__global__ void __launch_bounds__(128) attn_bwd_dkdv_kernel(Params p) {
  using T = Elem<BF16>;
  constexpr int kLd = row_stride<DP, BF16>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kTile * kLd;
  T* Qs = Vs + kTile * kLd;
  T* Gs = Qs + kTile * kLd;   // dO rows
  float* Ls = reinterpret_cast<float*>(Gs + kTile * kLd);
  float* Ds = Ls + kTile;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, Tn = p.T, d = p.d;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int len = valid_keys(p, b);

  float dk[1][DP / 8][4], dv[1][DP / 8][4];
  zero(dk);
  zero(dv);
  if (k0 < len) {   // a tile of masked keys keeps its zeros
    const char* qb = head_base(p.q, b, h, sizeof(T));
    const char* gb = head_base(p.dout, b, h, sizeof(T));
    const float* lse = p.lse + (long long)bh * Tn;
    const float* delta = p.delta + (long long)bh * Tn;
    load_rows<DP, BF16, 128>(Ks, head_base(p.k, b, h, sizeof(T)), p.k.st, k0,
                             kTile, len, d);
    load_rows<DP, BF16, 128>(Vs, head_base(p.v, b, h, sizeof(T)), p.v.st, k0,
                             kTile, len, d);
    load_rows<DP, BF16, 128>(Qs, qb, p.q.st, 0, kTile, Tn, d);
    load_rows<DP, BF16, 128>(Gs, gb, p.dout.st, 0, kTile, Tn, d);
    cp_commit();
    if (threadIdx.x < kTile) {
      const bool in = threadIdx.x < Tn;
      Ls[threadIdx.x] = in ? lse[threadIdx.x] : 0.f;
      Ds[threadIdx.x] = in ? delta[threadIdx.x] : 0.f;
    }
    const T* Kw = Ks + warp * 16 * kLd;
    const T* Vw = Vs + warp * 16 * kLd;
    const int key0 = k0 + warp * 16 + g;

    for (int q0 = 0; q0 < Tn; q0 += kTile) {
      const bool more = q0 + kTile < Tn;
      cp_wait<0>();
      __syncthreads();
      float s[1][8][4], dp[1][8][4];
      zero(s);
      mm_nt<DP, BF16, true, 1>(s, Kw, Qs, lane);
      zero(dp);
      mm_nt<DP, BF16, true, 1>(dp, Vw, Gs, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tq + (e & 1);   // query within the tile
          s[0][j][e] =
              exp_arg<BF16>(__fmul_rn(s[0][j][e], p.scale) - Ls[c]);
        }
      if (q0 + kTile > Tn) mask_cols(s[0], q0, Tn, 0.f, lane);
      if (key0 + 8 >= len) {   // this thread's rows past lengths[b]
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * (e >> 1) >= len) s[0][j][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tq + (e & 1);
          dp[0][j][e] = s[0][j][e] * (dp[0][j][e] - Ds[c]) * p.scale;
        }
      mm_pn<DP, BF16, 1>(dv, s, Gs, lane);
      mm_pn<DP, BF16, 1>(dk, dp, Qs, lane);
      __syncthreads();   // every warp is done with Q_i, dO_i, lse_i, D_i
      if (more) {
        const int q1 = q0 + kTile;
        load_rows<DP, BF16, 128>(Qs, qb, p.q.st, q1, kTile, Tn, d);
        load_rows<DP, BF16, 128>(Gs, gb, p.dout.st, q1, kTile, Tn, d);
        cp_commit();
        if (threadIdx.x < kTile) {
          const int row = q1 + threadIdx.x;
          Ls[threadIdx.x] = row < Tn ? lse[row] : 0.f;
          Ds[threadIdx.x] = row < Tn ? delta[row] : 0.f;
        }
      }
    }
  }
  store_rows<DP, BF16>(p.dk, b, h, k0 + warp * 16, Tn, d, dk[0], nullptr,
                       lane);
  store_rows<DP, BF16>(p.dv, b, h, k0 + warp * 16, Tn, d, dv[0], nullptr,
                       lane);
}

template <int DP, bool BF16>
constexpr size_t tile_bytes() {
  return sizeof(Elem<BF16>) * kTile * row_stride<DP, BF16>();
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, int NW, int MT, bool BF16>
cudaError_t forward_rows(const Params& p, cudaStream_t s) {
  constexpr int kRows = 16 * MT * NW;
  const size_t smem = tile_bytes<DP, BF16>() * (2 * kTile + kRows) / kTile;
  const dim3 grid((p.T + kRows - 1) / kRows, p.B * p.H);
  return launch(attn_fwd_kernel<DP, NW, MT, BF16>, grid, 32 * NW, smem, p,
                s);
}

// Queries per block, a choice by type and shape made at launch: in fp32,
// 128 (warps of 32 rows: each K/V fragment is read and split once for two
// row tiles) where those blocks cover the SMs and T wastes at most an
// eighth of the last one; else 64. (bf16 has no split to share, and 32-row
// warps take 255 registers there: on the card they were no faster. Blocks
// of 32 or 16 queries with 2 or 1 warps, for grids that leave SMs idle,
// were slower on the card than 64 at every shape tried:
// tools/torch_attn_blocks.py.)
template <int DP, bool BF16>
cudaError_t forward(const Params& p, int sms, cudaStream_t s) {
  if constexpr (!BF16) {
    const int t128 = (p.T + 127) / 128;
    if ((long long)p.B * p.H * t128 >= sms && (t128 * 128 - p.T) * 8 <= p.T)
      return forward_rows<DP, 4, 2, BF16>(p, s);
  }
  return forward_rows<DP, 4, 1, BF16>(p, s);
}

template <int DP, bool BF16>
cudaError_t backward(const Params& p, cudaStream_t s) {
  const size_t smem = 4 * tile_bytes<DP, BF16>() + 2 * kTile * sizeof(float);
  const dim3 grid((p.T + kTile - 1) / kTile, p.B * p.H);
  cudaError_t err = launch(attn_bwd_dq_kernel<DP, BF16>, grid, 128, smem, p, s);
  if (err != cudaSuccess) return err;
  return launch(attn_bwd_dkdv_kernel<DP, BF16>, grid, 128, smem, p, s);
}

template <bool BF16>
cudaError_t forward_any(const Params& p, int sms, cudaStream_t s) {
  if (p.d <= 64) return forward<64, BF16>(p, sms, s);
  if (p.d <= 96) return forward<96, BF16>(p, sms, s);
  return forward<128, BF16>(p, sms, s);
}

template <bool BF16>
cudaError_t backward_any(const Params& p, cudaStream_t s) {
  if (p.d <= 64) return backward<64, BF16>(p, s);
  if (p.d <= 96) return backward<96, BF16>(p, s);
  return backward<128, BF16>(p, s);
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
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? forward_any<true>(p, sms, s) : forward_any<false>(p, sms, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? backward_any<true>(p, s) : backward_any<false>(p, s);
  return (int)err;
}

const char* attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
