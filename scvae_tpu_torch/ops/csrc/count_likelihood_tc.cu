// K2 / K3 on the tensor cores: the fused decoder heads and count
// log-likelihood of the Poisson, NB, ZIP and ZINB families, forward and
// backward, for compute_dtype=bfloat16 (the bf16 training path) and for
// float32 (precision="float32", and the JAX package's own choice on any
// backend but a TPU).
//
// Replaces the Pallas kernels of scvae_tpu/ops/fused_likelihood.py:
// _make_forward_kernel driven by _fused_forward (K2) and
// _make_backward_kernel driven by _fused_backward (K3).  For M rows of
// h (M, H) and the family's heads W_k (H, F), b_k (F,), with bf16:
//
//   a_k  = bf16(h) bf16(W_k) + b_k     (float32 sums, b_k unrounded)
//   ll   = sum_f log p(t | a)          (support clips; -lgamma(1 + t) if asked)
//   da_k = g * dll/da_k                (float32; zero outside each clip range)
//   dh   = sum_k bf16(da_k) W_k^T,  dW_k = h^T bf16(da_k),  db_k = sum_rows da_k
//
// Operands arrive in bf16 from the wrapper: h (M, Hp) and the heads'
// weights side by side, W (Hp, NH, Fp), zero-padded to Hp, Fp = multiples
// of 8 so that every row starts on 16 bytes.  Here:
//
//   tc_heads_kernel<Fam, false>  forward: one block per 64 rows x 64
//       genes, all NH heads; writes the block's row sums of ll to a
//       (gene tiles, M) partial array, which reduce_kernel sums in order.
//   tc_heads_kernel<Fam, true>   the same products, then da_k: rounded
//       to bf16 into a (M, NH * Fp) scratch, and the unrounded column sums
//       of the block's rows into a (row tiles, NH * Fp) partial array.
//
// Float32 (SEG = kSplitPairs, tc_common.cuh): JAX multiplies float32 h and
// W, and the backward float32 da.  So each goes to the tensor cores as
// kSplitTerms = 3 bf16 terms, x_0 = bf16(x), x_k = bf16(x - x_0 - ... -
// x_(k-1)), which leave at most 2^-24 |x|, and every product takes the
// pairs of terms (i, j) with i + j < 3, by i then j (P = 6 pairs):
//
//   a_k  = sum over the pairs of h_j W_k,i + b_k      (float32, pair order)
//   da_k = g * dll/da_k                               (float32), in 3 terms
//   dh   = sum over the pairs of da_i W_j^T          (every head)
//   dW_k = sum over the pairs of h_j^T da_k,i,  db_k = sum_rows da_k
//
// The float32 entries first split h and W (split_pack_kernel; its plain
// version is fused_likelihood.split_bf16) into the pair layouts, in scratch
// that the wrapper allocates: h's terms per pair H (M, P, Hp), h_j of pair
// p in slot p, and the heads' W terms per pair W (Hp, P, NH, Fp), W_j of
// pair p in block p (so W_i in block i < 3).  The heads kernel runs its
// depth over the P
// slots of H, slot p against W's block i of pair p, so the forward and the
// gradient kernel sum the very same a; the gradient kernel writes da's
// term i of pair p into slot p of a (M, P * NH * Fp) scratch.  Then dh is
// the scratch times W^T over the depth P * NH * Fp, and dW is H^T times
// the scratch read as P * M rows of NH * Fp (tc_product.cu).  The forward
// reads W's blocks 0-2 only, but takes the same layouts as the gradient
// kernel: one slot per term (h (M, 3, Hp), W (Hp, 3, NH, Fp)) saves the
// pack 0.002-0.005 ms and costs the heads kernel 0.003-0.033 ms more on
// the H100 (its W rows half as far apart), and splitting h in the ring as
// it is staged doubled the forward (PERF.md §6).
// tools/f32_split_precision.py reads this design's error against the
// number of terms: two terms of each read up to 2.1e-5 of the largest
// value where the activations reach the exponentials' clip (the checks
// allow 2e-5), three read at most 4.3e-6.

// The backward's dh = da W^T and dW = h^T da (with db from the column sums)
// are plain products of that scratch (tc_product.cu).  So the backward
// computes the activations and the transcendentals once, and every
// cross-block sum runs in a fixed order: no atomics, results repeat bit for
// bit.
//
// Bound on the H100 at the headline shape (M = F = 2048, H = 256): the head
// products, 2 * heads * M * H * F FLOP (2.15 GFLOP per head) per product,
// against h + heads * (W + b) + t bytes; one or two heads are bound by
// bytes at 3.35 TB/s, three by operations at 989 TFLOP/s.  What the design
// does about it: the products run on the ring of tc_common.cuh (mma.sync;
// they are a small share of these kernels' time).  A block of 64 rows x 64
// genes (1,024 blocks at the headline shape, 10,240 over the GMVAE's 20,480
// rows) asks for 16 warps per SM (12 for three heads).  The epilogue's
// float32 transcendentals, not the products, set the kernels' time.  The
// bf16 da scratch (8 MB per head at 2,048 rows) costs little next to
// recomputing the activations a second time.  Float32: the function moves
// the same bytes with h and W in float32, and its product is counted once
// (the split's six pairs are the design's cost, not the function's); the
// pairs take the ring's products six times, and the scratch holds six bf16
// terms of da per head (da_0 three times, da_1 twice, da_2 once).

#include "tc_common.cuh"

namespace scvae {
namespace {

// Blocks per SM that the heads kernels ask the compiler to fit: 16 warps,
// or 12 for three heads, whose accumulators take more registers.
template <int NH>
constexpr int tc_heads_min_blocks() {
  constexpr int warps = NH >= 3 ? 12 : 16;
  return warps / kTcWarps > 1 ? warps / kTcWarps : 1;
}

// The heads' products of a block of 64 rows x 64 genes, then its epilogue.
// The accumulators are staged in shared memory as act[hd][row][col]; then
// each warp takes rows in turn, its lanes the columns lane and lane + 32, so
// that the targets load and the da scratch stores coalesce and the
// epilogue's code stays one loop.
// GRAD = false (K2): part[blockIdx.y][row] = the block's sum over its genes
// of ll (minus lgamma(1 + t) if asked).  GRAD = true (K3, first half):
// da[row][hd * fp + gene] = bf16(g[row] dll/da_hd), zero past F, and
// part[blockIdx.x][hd * fp + gene] = the block's sum over its rows of the
// unrounded values.  Targets t (m_t, f) are float32 or (t_bf16) bf16; row
// m reads target row m % m_t.  SEG = kSplitPairs: the float32 instance, h
// (M, P Hp) and w (Hp, P, NH, Fp) the terms per pair, and da[row][(p NH +
// hd) fp + gene] the term split_first(p) of the value, for each pair p.
template <class Fam, bool GRAD, int SEG = 1>
__global__ void __launch_bounds__(kTcThreads,
                                  tc_heads_min_blocks<Fam::kHeads>())
    tc_heads_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const float* __restrict__ bias, const void* __restrict__ t,
                    int t_bf16, const float* __restrict__ g,
                    float* __restrict__ part, bf16* __restrict__ da, int m,
                    int m_t, int hp, int f, int fp, int subtract_const) {
  constexpr int NH = Fam::kHeads;
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem_raw);
  float* act = reinterpret_cast<float*>(tc_smem_raw);  // after the mainloop

  const int m0 = blockIdx.x * kTcRows, n0 = blockIdx.y * kTcTileN;
  const int width = NH * fp;   // one pair's columns of w and of da
  const int ldd = SEG * width;
  float acc[NH][kTcMI][4][4];
  tc_mainloop<NH, SEG>(smem, TcOperands{h, m, hp, w, ldd, fp, width, width},
                       m0, n0, acc);
  tc_stage_acts<NH>(act, acc);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float b_l[NH][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gene = n0 + lane + 32 * j;
#pragma unroll
    for (int hd = 0; hd < NH; ++hd)
      b_l[hd][j] = gene < f ? bias[hd * f + gene] : 0.0f;
  }
  float col_acc[NH][2];
#pragma unroll
  for (int hd = 0; hd < NH; ++hd) col_acc[hd][0] = col_acc[hd][1] = 0.0f;

#pragma unroll 2
  for (int r = warp; r < kTcRows && m0 + r < m; r += kTcWarps) {
    const int row = m0 + r;
    const long long t_row = (long long)(row % m_t) * f;
    const float grow = GRAD ? g[row] : 0.0f;
    float row_ll = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, gene = n0 + c;
      const bool ok = gene < f;
      float a[NH];
#pragma unroll
      for (int hd = 0; hd < NH; ++hd)
        a[hd] = act[(hd * kTcRows + r) * kTcActStride + c] + b_l[hd][j];
      const float tv = ok ? load_t(t, t_bf16, t_row + gene) : 0.0f;
      if constexpr (!GRAD) {
        if (ok) {
          float ll = Fam::ll(a, tv);
          if (subtract_const) ll -= series_lgamma(1.0f + tv);
          row_ll += ll;
        }
      } else {
        float gr[NH];
#pragma unroll
        for (int hd = 0; hd < NH; ++hd) gr[hd] = 0.0f;
        if (ok) {
          Fam::grads(a, tv, nullptr, gr);
#pragma unroll
          for (int hd = 0; hd < NH; ++hd) gr[hd] *= grow;
        }
        if (gene < fp) {
#pragma unroll
          for (int hd = 0; hd < NH; ++hd) {
            bf16* out = da + (long long)row * ldd + hd * fp + gene;
            if constexpr (SEG == 1) {
              *out = __float2bfloat16_rn(gr[hd]);
            } else {
              bf16 term[kSplitTerms];
              split_terms(gr[hd], term);
#pragma unroll
              for (int p = 0; p < SEG; ++p)
                out[p * width] = term[split_first(p)];
            }
            col_acc[hd][j] += gr[hd];
          }
        }
      }
    }
    if constexpr (!GRAD) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        row_ll += __shfl_xor_sync(0xffffffffu, row_ll, off);
      if (lane == 0) part[(long long)blockIdx.y * m + row] = row_ll;
    }
  }

  if constexpr (GRAD)
    tc_store_col_sums<NH>(act, col_acc, part + (long long)blockIdx.x * width,
                          n0, fp, NH);
}

template <class Fam, bool GRAD, int SEG = 1>
int launch_heads(const bf16* h, const bf16* w, const float* b, const void* t,
                 int t_bf16, const float* g, float* part, bf16* da, int m,
                 int m_t, int hp, int f, int subtract_const,
                 cudaStream_t stream) {
  const dim3 grid((m + kTcRows - 1) / kTcRows, (f + kTcTileN - 1) / kTcTileN);
  if (grid.x == 0 || grid.y == 0) return 0;
  const size_t bytes = tc_heads_smem<Fam::kHeads>();
  auto kernel = tc_heads_kernel<Fam, GRAD, SEG>;
  if (int err = set_smem(kernel, bytes)) return err;
  const int fp = (f + 7) / 8 * 8;
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      h, w, b, t, t_bf16, g, part, da, m, m_t, hp, f, fp, subtract_const);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB,
// 2 = ZIP, 3 = ZINB (NH = 1, 2, 2, 3 heads).  h: bf16 (m, hp); w: bf16
// (hp, NH, fp); b: float32 (NH, f); t: (m_t, f), t_dtype 0 = float32,
// 1 = bfloat16; hp and fp are h's and w's padded widths (multiples of 8 at
// least hidden and f).  The float32 entries (scvae_tc_f32_*) take float32
// h (m, hidden) and the heads' W_k (hidden, f) as w0, w1, w2 (null past the
// family's heads), split them into their terms per pair in the scratch hh
// (m, P, hp) and wp (hp, P, NH, fp), P = kSplitPairs, and run the kernels
// on those (the products of the backward read them too).

// K2: part (ceil(f / 64), m) scratch, out (m,).
int scvae_tc_forward(int family, const void* h, const void* w,
                     const float* b, const void* t, int t_dtype, float* part,
                     float* out, int m, int m_t, int hp, int f,
                     int subtract_const, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return launch_heads<Fam, false>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), b, t,
        t_dtype, nullptr, part, nullptr, m, m_t, hp, f, subtract_const, s);
  });
  if (err) return err;
  return launch_reduce(part, (f + kTcTileN - 1) / kTcTileN, m, out, s);
}

// K3, first half: da (m, NH * fp) bf16 scratch and db_part
// (ceil(m / 64), NH * fp) float32 scratch, for row cotangents g (m,).
int scvae_tc_gradient(int family, const float* g, const void* h,
                      const void* w, const float* b, const void* t,
                      int t_dtype, void* da, float* db_part, int m, int m_t,
                      int hp, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return launch_heads<Fam, true>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), b, t,
        t_dtype, g, db_part, static_cast<bf16*>(da), m, m_t, hp, f, 0, s);
  });
}

// The float32 K2: the operands' split, then as scvae_tc_forward.
int scvae_tc_f32_forward(int family, const float* h, const float* w0,
                         const float* w1, const float* w2, const float* b,
                         const void* t, int t_dtype, void* hh, void* wp,
                         float* part, float* out, int m, int m_t, int hidden,
                         int f, int subtract_const, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = (hidden + 7) / 8 * 8, fp = (f + 7) / 8 * 8;
  const int err = with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    if (int e = launch_split_operands(Fam::kHeads, h, w0, w1, w2, nullptr,
                                      0, static_cast<bf16*>(hh),
                                      static_cast<bf16*>(wp), m, hidden, hp,
                                      f, fp, s))
      return e;
    return launch_heads<Fam, false, kSplitPairs>(
        static_cast<const bf16*>(hh), static_cast<const bf16*>(wp), b, t,
        t_dtype, nullptr, part, nullptr, m, m_t, hp, f, subtract_const, s);
  });
  if (err) return err;
  return launch_reduce(part, (f + kTcTileN - 1) / kTcTileN, m, out, s);
}

// The float32 K3, first half: the operands' split into hh and wp, which the
// products read after it, then da (m, P * NH * fp) bf16 scratch of da's
// terms per pair and db_part (ceil(m / 64), NH * fp) float32 scratch.
int scvae_tc_f32_gradient(int family, const float* g, const float* h,
                          const float* w0, const float* w1, const float* w2,
                          const float* b, const void* t, int t_dtype,
                          void* hh, void* wp, void* da, float* db_part, int m,
                          int m_t, int hidden, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = (hidden + 7) / 8 * 8, fp = (f + 7) / 8 * 8;
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    if (int e = launch_split_operands(Fam::kHeads, h, w0, w1, w2, nullptr,
                                      0, static_cast<bf16*>(hh),
                                      static_cast<bf16*>(wp), m, hidden, hp,
                                      f, fp, s))
      return e;
    return launch_heads<Fam, true, kSplitPairs>(
        static_cast<const bf16*>(hh), static_cast<const bf16*>(wp), b, t,
        t_dtype, g, db_part, static_cast<bf16*>(da), m, m_t, hp, f, 0, s);
  });
}

}  // extern "C"
