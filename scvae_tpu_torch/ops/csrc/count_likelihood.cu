// K2 / K3: fused decoder heads + count log-likelihood, forward and backward,
// for the Poisson, negative-binomial, zero-inflated Poisson and zero-inflated
// negative-binomial families.
//
// Replaces the Pallas kernels of scvae_tpu/ops/fused_likelihood.py:
// _make_forward_kernel driven by _fused_forward (K2) and _make_backward_kernel
// driven by _fused_backward (K3), with the (ll, grads) pairs of _BASE_LL /
// _BASE_GRADS.  For M rows of decoder output h (M, H) and the family's heads
// k with weights W_k (H, F) and biases b_k (F,):
//
//   a_k = h W_k + b_k                (bf16-rounded inputs when asked, f32 sums)
//   ll  = sum_f log p(t | a)          (support clips; -lgamma(1 + t) if asked)
//   da_k = g * dll/da_k               (zero outside each clip range)
//   dh   = sum_k bf16(da_k) W_k^T,  dW_k = h^T bf16(da_k),  db_k = sum_rows da_k
//
// The (M, F) activations never reach device memory: every kernel recomputes
// them tile by tile (fused_heads.cuh), as the TPU kernels do.  The TPU
// backward accumulates dh and dW by revisiting output blocks across a
// sequential grid; CUDA blocks run in no order, so the backward is two
// deterministic passes without atomics: row_tile_kernel<.., true> (one block
// per row tile and dh column chunk, looping over genes) and dw_kernel (one
// block per gene tile and dW row chunk, looping over rows).  The forward is
// row_tile_kernel<.., false>, its row sums reduced across the warp in a fixed
// order.
//
// Bound on the H100 at the headline shape (M = F = 2048, H = 256, bf16
// inputs): the head products, 2 * heads * M * H * F FLOP (2.15 GFLOP per head)
// per pass and one more product per backward pass, against h + heads * (W + b)
// + t bytes (12.6 MB for one head, 16.8 MB for three).  One head (Poisson) and
// two (ZIP, NB) are bound by bytes at 3.35 TB/s, three (ZINB) by operations at
// 989 TFLOP/s.  This first version runs the products as float FMAs on the
// CUDA cores from shared-memory tiles (no tensor cores, TMA or wgmma), far
// above that bound.
//
// The families' device ll / grads are in count_families.cuh.

#include "count_families.cuh"

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB,
// 2 = ZIP, 3 = ZINB; head k's weights are wk, bk (null past the family's
// heads).  t_dtype: 0 = float32, 1 = bfloat16.  h rows cycle over the m_t
// rows of t (m % m_t == 0).

int scvae_fused_forward(int family, const float* h, const float* w0,
                        const float* b0, const float* w1, const float* b1,
                        const float* w2, const float* b2, const void* t,
                        int t_dtype, float* out, int m, int m_t, int hidden,
                        int f, int round_bf16, int subtract_const,
                        void* stream) {
  if (m == 0) return 0;
  const Heads heads{{w0, w1, w2}, {b0, b1, b2}};
  const RowExtras none{nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      return launch_row_tile<Fam, decltype(tt), false>(
          nullptr, h, heads, none, t, out, m, m_t, hidden, f, round_bf16,
          subtract_const, s);
    });
  });
}

int scvae_fused_backward_dh(int family, const float* g, const float* h,
                            const float* w0, const float* b0, const float* w1,
                            const float* b1, const float* w2, const float* b2,
                            const void* t, int t_dtype, float* dh, int m,
                            int m_t, int hidden, int f, int round_bf16,
                            void* stream) {
  if (m == 0) return 0;
  const Heads heads{{w0, w1, w2}, {b0, b1, b2}};
  const RowExtras none{nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      return launch_row_tile<Fam, decltype(tt), true>(
          g, h, heads, none, t, dh, m, m_t, hidden, f, round_bf16, 0, s);
    });
  });
}

int scvae_fused_backward_dw(int family, const float* g, const float* h,
                            const float* w0, const float* b0, const float* w1,
                            const float* b1, const float* w2, const float* b2,
                            const void* t, int t_dtype, float* dw0, float* db0,
                            float* dw1, float* db1, float* dw2, float* db2,
                            int m, int m_t, int hidden, int f, int round_bf16,
                            void* stream) {
  if (f == 0) return 0;
  const Heads heads{{w0, w1, w2}, {b0, b1, b2}};
  const HeadGrads out{{dw0, dw1, dw2}, {db0, db1, db2}};
  const RowExtras none{nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      return launch_dw<Fam, decltype(tt)>(g, h, heads, none, t, out, m, m_t,
                                          hidden, f, round_bf16, s);
    });
  });
}

}  // extern "C"
