// K6 / K7 of the constrained Poisson on the tensor cores, for bf16 h (the
// bf16 training path, whose decoder output arrives with bf16 values while W
// stays float32) and for float32 h (precision="float32", the JAX package's
// own choice on any backend but a TPU).
//
// Replaces the Pallas kernels of scvae_tpu/ops/fused_likelihood.py that
// _cp_fused_forward (K6) and _cp_fused_backward (K7) drive.  Per row, with
// the count sum n:
//
//   a   = h W + b                                   (float32)
//   lse = logsumexp over genes of a
//   ll  = sum_f (t a - lgamma(1 + t)) - (sum_f t)(lse - log n) - n
//   da  = g (t - (sum_f t) exp(a - lse))
//   dh  = da W^T,  dW = h^T da,  db = sum_rows da
//
// The JAX kernels multiply the unrounded float32 W and da (and, in float32,
// h).  So the unrounded operands go to the tensor cores as sums of bf16
// terms, x_0 = bf16(x), x_k = bf16(x - x_0 - ... - x_(k-1)), and a product
// as the pairs of terms (x_i, y_j) with i + j < terms, by i then j.
//
// bf16 h (SEG = 1): the wrapper splits W into kCpTerms = 2 terms, and this
// kernel splits da the same way; two terms leave at most 2^-16 |x|
// (tools/cp_split_precision.py reads the error against the term count).
// The pairs are laid along the depth of one product:
//
//   a  = h W_0 + h W_1 + b           (h exact in bf16; sums in term order)
//   dh = [da_0 | da_0 | da_1] [W_0 | W_1 | W_0]^T          (tc_product.cu)
//   dW = h^T da_0 + h^T da_1: the scratch as rows of Fp against h repeated
//        once per pair, zero where the pair's W term is not W_0 (tc_product.cu)
//
// Its operands arrive in bf16 from the wrapper: h (M, Hp) and the W terms
// per pair, W (Hp, P, Fp) (the heads layout of the base families'
// kernels), whose first kCpTerms heads are W_0, W_1.
//
// Float32 h (SEG = kSplitPairs): the split-bf16 design of the base
// families' float32 K2/K3 (count_likelihood_tc.cu, tc_common.cuh) with one
// head.  The float32 entries first split h and W into kSplitTerms = 3 bf16
// terms laid per pair (split_pack_kernel: h (M, P, Hp), W (Hp, P, 1, Fp),
// P = 6); both kernels run the ring over the six pairs (i, j), i + j < 3,
// as depth segments, h_j of slot p against W's block i of pair p, so that a
// sums h_j W_i over the pairs in pair order.  The gradient kernel splits da
// into its three terms and writes term i of pair p into slot p of the
// scratch (M, P * Fp); dh is that scratch times W^T over the depth P * Fp,
// dW h's slots read as P * M rows against it (tc_product.cu).  db sums the
// unrounded da.  tools/f32_split_precision.py --families cp reads this
// design's error against the number of terms (PERF.md).  Hp and Fp are
// multiples of 8 in both instances.
//
//   cp_tc_forward_kernel   one block per 64 rows x 64 genes: the products
//       through the ring of tc_common.cuh, then per row of the block its
//       partials over the block's genes: the max of a, sum exp(a - max),
//       sum (t a - lgamma(1 + t)) and sum t, into (4, gene tiles, M)
//       arrays.
//   cp_merge_kernel        per row, the gene tiles' partials in order with
//       (m, s) + (m', s') = (M, s e^(m - M) + s' e^(m' - M)); writes ll and
//       lse.
//   cp_tc_gradient_kernel  the same products and the same float32 sums, so
//       exp(a - lse) takes the very a whose exponentials the forward summed;
//       then da's terms per pair into a (M, P * Fp) bf16 scratch, zero past
//       F, and the unrounded column sums of the block's rows into a
//       (row tiles, Fp) partial array for db.
//
// The TPU kernel carries a running (max, sumexp) across its sequential
// gene-tile grid axis; here the blocks of a row run in parallel and the
// merge is a second pass.  One block per 64 rows x 64 genes gives 1,024
// blocks at the headline shape, where one block per 64 rows walking every
// gene would leave most of the 132 SMs idle.  Every cross-block sum runs in
// a fixed order, without atomics: the results repeat bit for bit.
//
// Bound on the H100 at the headline shape (M = F = 2,048, H = 256): the
// function's product, 2 M H F = 2.15 GFLOP, at 989 TFLOP/s is 2.2 us,
// counted once however many pairs of terms the design multiplies; the
// forward moves about 12.6 MB (h and W in float32 as the caller holds them,
// bf16 t; 3.8 us at 3.35 TB/s): bytes bound it.  The gradient kernel also
// writes da (the function's: bf16 terms with bf16 h, float32 once with
// float32 h).  What the design does about it: the products run on mma.sync
// from the ring (a small share of the time; six pairs in float32 against
// two W terms with bf16 h); the float32 epilogue, a warp per row with its
// lanes along the genes, reads t and writes the scratch coalesced.  The
// scratch holds a term per pair (bf16 h: da_0 twice; float32: da_0 three
// times, da_1 twice), 25 and 50 MB at the headline shape.

#include <math.h>

#include "tc_common.cuh"

namespace scvae {
namespace {

constexpr int kCpTerms = 2;  // bf16 terms of W and of da (CP_TERMS)
constexpr int kCpPairs = kCpTerms * (kCpTerms + 1) / 2;
constexpr int kCpPartials = 4;  // max, sum exp(a - max), sum ll, sum t
constexpr int kCpMinBlocks = 4;  // 16 warps per SM, as the two-head kernels

// The da term i of pair p (pairs (i, j) with i + j < kCpTerms, by i then j).
__host__ __device__ constexpr int cp_da_term(int p) {
  int i = 0;
  while (p >= kCpTerms - i) {
    p -= kCpTerms - i;
    ++i;
  }
  return i;
}

// Weight tiles the ring carries per stage: the kCpTerms W terms with bf16 h
// (SEG = 1), one pair's W term with float32 h (SEG = kSplitPairs).
template <int SEG>
constexpr int cp_ring_heads() {
  return SEG == 1 ? kCpTerms : 1;
}

// Pairs of terms in da's scratch: kCpPairs or kSplitPairs.
template <int SEG>
constexpr int cp_pairs() {
  return SEG == 1 ? kCpPairs : kSplitPairs;
}

// Dynamic shared memory: the ring, then (reusing it) the staged activations
// act[64][72].
template <int SEG>
constexpr size_t cp_smem() {
  constexpr size_t ring = TcSmem<cp_ring_heads<SEG>()>::kBytes;
  constexpr size_t acts = sizeof(float) * kTcRows * kTcActStride;
  return ring > acts ? ring : acts;
}

// a - b of the block's 64 rows x 64 genes, staged as act[row][col].  SEG =
// 1: the products of h with the W terms (the first kCpTerms heads of w,
// (Hp, P, Fp)), summed in float32 in term order.  SEG = kSplitPairs: h
// (M, P Hp) and w (Hp, P, 1, Fp) the terms per pair, the ring's depth over
// the pairs.  Both kernels call this, so they add the same terms in the
// same order.
template <int SEG>
__device__ __forceinline__ void cp_activations(bf16* smem, float* act,
                                               const bf16* h, const bf16* w,
                                               int m, int hp, int fp, int m0,
                                               int n0) {
  constexpr int NB = cp_ring_heads<SEG>();
  const int ldw = cp_pairs<SEG>() * fp;
  float acc[NB][kTcMI][4][4];
  // bf16 h: head k of the ring at columns k fp, past F read as the next
  // head's (masked by the epilogue); float32: zero past Fp in each block
  tc_mainloop<NB, SEG>(
      smem, TcOperands{h, m, hp, w, ldw, fp, SEG == 1 ? ldw : fp, fp}, m0,
      n0, acc);
  if constexpr (NB == 1) {
    tc_stage_acts<1>(act, acc);
  } else {
    float sum[1][kTcMI][4][4];
#pragma unroll
    for (int mi = 0; mi < kTcMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = acc[0][mi][ni][e];
#pragma unroll
          for (int k = 1; k < NB; ++k) s += acc[k][mi][ni][e];
          sum[0][mi][ni][e] = s;
        }
    tc_stage_acts<1>(act, sum);
  }
  __syncthreads();
}

// K6, first pass: part[(q * tiles + blockIdx.y) * m + row] for the
// partials q = 0..3 of each row over the block's genes.  Targets t (m_t, f)
// are float32 or (t_bf16) bf16; row m reads target row m % m_t.
template <int SEG>
__global__ void __launch_bounds__(kTcThreads, kCpMinBlocks)
    cp_tc_forward_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias,
                         const void* __restrict__ t, int t_bf16,
                         float* __restrict__ part, int m, int m_t, int hp,
                         int f, int fp) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem_raw);
  float* act = reinterpret_cast<float*>(tc_smem_raw);  // after the mainloop
  const int m0 = blockIdx.x * kTcRows, n0 = blockIdx.y * kTcTileN;
  cp_activations<SEG>(smem, act, h, w, m, hp, fp, m0, n0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long slice = (long long)gridDim.y * m;
  float b_l[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gene = n0 + lane + 32 * j;
    b_l[j] = gene < f ? bias[gene] : 0.0f;
  }
  for (int r = warp; r < kTcRows && m0 + r < m; r += kTcWarps) {
    const int row = m0 + r;
    const long long t_row = (long long)(row % m_t) * f;
    float a[2];
    float mx = -INFINITY, ll = 0.0f, sx = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, gene = n0 + c;
      a[j] = -INFINITY;  // masked: exp(a - max) = 0
      if (gene < f) {
        a[j] = act[r * kTcActStride + c] + b_l[j];
        const float tv = load_t(t, t_bf16, t_row + gene);
        ll += tv * a[j] - series_lgamma(1.0f + tv);
        sx += tv;
        mx = fmaxf(mx, a[j]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float se = expf(a[0] - mx) + expf(a[1] - mx);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, off);
      ll += __shfl_xor_sync(0xffffffffu, ll, off);
      sx += __shfl_xor_sync(0xffffffffu, sx, off);
    }
    if (lane == 0) {
      float* p = part + (long long)blockIdx.y * m + row;
      p[0] = mx;
      p[slice] = se;
      p[2 * slice] = ll;
      p[3 * slice] = sx;
    }
  }
}

// (m, s) <- (m, s) + (m2, s2) for running (max, sum of exp(x - max)); an
// empty side has m = -inf and s = 0.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

constexpr int kCpMergeThreads = 256;

// K6, second pass: a thread per row merges the row's gene tiles in order.
__global__ void __launch_bounds__(kCpMergeThreads)
    cp_merge_kernel(const float* __restrict__ part, int tiles,
                    const float* __restrict__ n, float* __restrict__ ll_out,
                    float* __restrict__ lse_out, int m) {
  const long long slice = (long long)tiles * m;
  for (long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       row < m; row += (long long)gridDim.x * blockDim.x) {
    float mx = -INFINITY, se = 0.0f, ll = 0.0f, sx = 0.0f;
    for (int k = 0; k < tiles; ++k) {
      const float* p = part + (long long)k * m + row;
      lse_merge(mx, se, p[0], p[slice]);
      ll += p[2 * slice];
      sx += p[3 * slice];
    }
    const float lse = mx + logf(se), nv = n[row];
    lse_out[row] = lse;
    ll_out[row] = ll - sx * (lse - logf(nv)) - nv;
  }
}

// K7, first kernel: da[row][p * fp + gene] = term i of pair p of
// g[row] (t - sx exp(a - lse[row])), zero past F, for each pair p
// (cp_da_term with bf16 h, split_first in float32), with sx per target row
// (m_t,); part[blockIdx.x][gene] = the block's sum over its rows of the
// unrounded values.
template <int SEG>
__global__ void __launch_bounds__(kTcThreads, kCpMinBlocks)
    cp_tc_gradient_kernel(const float* __restrict__ g,
                          const bf16* __restrict__ h,
                          const bf16* __restrict__ w,
                          const float* __restrict__ bias,
                          const void* __restrict__ t, int t_bf16,
                          const float* __restrict__ lse,
                          const float* __restrict__ sx,
                          bf16* __restrict__ da, float* __restrict__ part,
                          int m, int m_t, int hp, int f, int fp) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem_raw);
  float* act = reinterpret_cast<float*>(tc_smem_raw);  // after the mainloop
  const int m0 = blockIdx.x * kTcRows, n0 = blockIdx.y * kTcTileN;
  cp_activations<SEG>(smem, act, h, w, m, hp, fp, m0, n0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long ldd = (long long)cp_pairs<SEG>() * fp;
  float b_l[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gene = n0 + lane + 32 * j;
    b_l[j] = gene < f ? bias[gene] : 0.0f;
  }
  float col_acc[1][2] = {{0.0f, 0.0f}};
#pragma unroll 2
  for (int r = warp; r < kTcRows && m0 + r < m; r += kTcWarps) {
    const int row = m0 + r;
    const int t_row = row % m_t;
    const float grow = g[row], lse_r = lse[row], sx_r = sx[t_row];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, gene = n0 + c;
      float d = 0.0f;
      if (gene < f) {
        const float a = act[r * kTcActStride + c] + b_l[j];
        const float tv = load_t(t, t_bf16, (long long)t_row * f + gene);
        d = grow * (tv - sx_r * expf(a - lse_r));
      }
      if (gene < fp) {
        bf16* out = da + (long long)row * ldd + gene;
        if constexpr (SEG == 1) {
          bf16 term[kCpTerms];
          float rest = d;
#pragma unroll
          for (int k = 0; k < kCpTerms; ++k) {
            term[k] = __float2bfloat16_rn(rest);
            rest -= __bfloat162float(term[k]);
          }
#pragma unroll
          for (int p = 0; p < kCpPairs; ++p) out[p * fp] = term[cp_da_term(p)];
        } else {
          bf16 term[kSplitTerms];
          split_terms(d, term);
#pragma unroll
          for (int p = 0; p < SEG; ++p) out[p * fp] = term[split_first(p)];
        }
        col_acc[0][j] += d;
      }
    }
  }
  tc_store_col_sums<1>(act, col_acc, part + (long long)blockIdx.x * fp, n0,
                       fp, 1);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem, dim3& grid, int m, int f) {
  grid = dim3((m + kTcRows - 1) / kTcRows, (f + kTcTileN - 1) / kTcTileN);
  return set_smem(kernel, smem);
}

// K6 on operands in the layout of SEG: the forward kernel, then the merge.
template <int SEG>
int launch_cp_forward(const bf16* h, const bf16* w, const float* b,
                      const void* t, int t_dtype, const float* n, float* part,
                      float* ll, float* lse, int m, int m_t, int hp, int f,
                      cudaStream_t s) {
  dim3 grid;
  auto kernel = cp_tc_forward_kernel<SEG>;
  if (int err = prepare(kernel, cp_smem<SEG>(), grid, m, f)) return err;
  kernel<<<grid, kTcThreads, cp_smem<SEG>(), s>>>(h, w, b, t, t_dtype, part,
                                                  m, m_t, hp, f,
                                                  (f + 7) / 8 * 8);
  if (int err = (int)cudaGetLastError()) return err;
  const int blocks = (m + kCpMergeThreads - 1) / kCpMergeThreads;
  cp_merge_kernel<<<blocks < 132 * 16 ? blocks : 132 * 16, kCpMergeThreads, 0,
                    s>>>(part, (int)grid.y, n, ll, lse, m);
  return (int)cudaGetLastError();
}

// K7's first kernel on operands in the layout of SEG.
template <int SEG>
int launch_cp_gradient(const float* g, const bf16* h, const bf16* w,
                       const float* b, const void* t, int t_dtype,
                       const float* lse, const float* sx, bf16* da,
                       float* db_part, int m, int m_t, int hp, int f,
                       cudaStream_t s) {
  dim3 grid;
  auto kernel = cp_tc_gradient_kernel<SEG>;
  if (int err = prepare(kernel, cp_smem<SEG>(), grid, m, f)) return err;
  kernel<<<grid, kTcThreads, cp_smem<SEG>(), s>>>(
      g, h, w, b, t, t_dtype, lse, sx, da, db_part, m, m_t, hp, f,
      (f + 7) / 8 * 8);
  return (int)cudaGetLastError();
}

// h (m, hidden) and W (hidden, f) in float32 into their terms per pair, hh
// (m, P, hp) and wp (hp, P, 1, fp).
int split_cp_operands(const float* h, const float* w, void* hh, void* wp,
                      int m, int hidden, int f, cudaStream_t s) {
  return launch_split_operands(1, h, w, nullptr, nullptr, nullptr, 0,
                               static_cast<bf16*>(hh), static_cast<bf16*>(wp),
                               m, hidden, (hidden + 7) / 8 * 8, f,
                               (f + 7) / 8 * 8, s);
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  b: float32 (f,); t: (m_t, f),
// t_dtype 0 = float32, 1 = bfloat16.  The bf16-h entries take h: bf16
// (m, hp) and w: bf16 (hp, P, fp), the W terms per pair, hp and fp h's and
// w's padded widths (multiples of 8 at least hidden and f).  The float32
// entries (scvae_cp_tc_f32_*) take float32 h (m, hidden) and W (hidden, f),
// split them into their terms per pair in the scratch hh (m, P, hp) and wp
// (hp, P, 1, fp), P = kSplitPairs, and run the kernels on those (the
// products of the backward read them too).

// K6: part (4, ceil(f / 64), m) scratch; ll, lse (m,) for count sums n (m,).
int scvae_cp_tc_forward(const void* h, const void* w, const float* b,
                        const void* t, int t_dtype, const float* n,
                        float* part, float* ll, float* lse, int m, int m_t,
                        int hp, int f, void* stream) {
  if (m == 0 || f == 0) return 0;
  return launch_cp_forward<1>(static_cast<const bf16*>(h),
                              static_cast<const bf16*>(w), b, t, t_dtype, n,
                              part, ll, lse, m, m_t, hp, f,
                              static_cast<cudaStream_t>(stream));
}

// K7, first kernel: da (m, P * fp) bf16 scratch and db_part
// (ceil(m / 64), fp) float32 scratch, for row cotangents g (m,), the
// forward's lse (m,) and sx (m_t,) = sum_f t per target row.
int scvae_cp_tc_gradient(const float* g, const void* h, const void* w,
                         const float* b, const void* t, int t_dtype,
                         const float* lse, const float* sx, void* da,
                         float* db_part, int m, int m_t, int hp, int f,
                         void* stream) {
  if (m == 0 || f == 0) return 0;
  return launch_cp_gradient<1>(g, static_cast<const bf16*>(h),
                               static_cast<const bf16*>(w), b, t, t_dtype,
                               lse, sx, static_cast<bf16*>(da), db_part, m,
                               m_t, hp, f, static_cast<cudaStream_t>(stream));
}

// The float32 K6: the operands' split, then as scvae_cp_tc_forward.
int scvae_cp_tc_f32_forward(const float* h, const float* w, const float* b,
                            const void* t, int t_dtype, const float* n,
                            void* hh, void* wp, float* part, float* ll,
                            float* lse, int m, int m_t, int hidden, int f,
                            void* stream) {
  if (m == 0 || f == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int err = split_cp_operands(h, w, hh, wp, m, hidden, f, s)) return err;
  return launch_cp_forward<kSplitPairs>(
      static_cast<const bf16*>(hh), static_cast<const bf16*>(wp), b, t,
      t_dtype, n, part, ll, lse, m, m_t, (hidden + 7) / 8 * 8, f, s);
}

// The float32 K7, first kernel: the operands' split into hh and wp, which
// the products read after it, then da (m, P * fp) bf16 scratch of da's
// terms per pair and db_part (ceil(m / 64), fp) float32 scratch.
int scvae_cp_tc_f32_gradient(const float* g, const float* h, const float* w,
                             const float* b, const void* t, int t_dtype,
                             const float* lse, const float* sx, void* hh,
                             void* wp, void* da, float* db_part, int m,
                             int m_t, int hidden, int f, void* stream) {
  if (m == 0 || f == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int err = split_cp_operands(h, w, hh, wp, m, hidden, f, s)) return err;
  return launch_cp_gradient<kSplitPairs>(
      g, static_cast<const bf16*>(hh), static_cast<const bf16*>(wp), b, t,
      t_dtype, lse, sx, static_cast<bf16*>(da), db_part, m, m_t,
      (hidden + 7) / 8 * 8, f, s);
}

}  // extern "C"
