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
// Transcendentals use the shift-3 series of special.cuh and the clip
// constants of the reference (_TINY, _P_HI, _L_LO, _L_HI).  Clips propagate
// NaN like jnp.clip.  The zero-inflated families evaluate both branches and
// select on t > 0, as jnp.where does, so a non-finite value of the branch not
// taken never reaches the result.

#include "fused_heads.cuh"

namespace scvae {
namespace {

// _poisson_ll / _poisson_grad; head: log_lambda.
struct Poisson {
  static constexpr int kHeads = 1;
  __device__ static float ll(const float* a, float t) {
    const float log_lam = clip(a[0], kLLo, kLHi);
    return t * log_lam - expf(log_lam);
  }
  __device__ static void grads(const float* a, float t, const float*,
                               float* g) {
    const bool inside = a[0] > kLLo && a[0] < kLHi;
    g[0] = inside ? t - expf(clip(a[0], kLLo, kLHi)) : 0.0f;
  }
};

// _nb_ll / _nb_grads; heads: p (logit), log_r.
struct NegativeBinomial {
  static constexpr int kHeads = 2;
  __device__ static float ll(const float* a, float t) {
    const float p = clip(sigmoid(a[0]), kTiny, kPHi);
    const float r = expf(clip(a[1], kLLo, kLHi));
    return series_lgamma(t + r) - series_lgamma(r) + r * log1pf(-p) +
           t * logf(p);
  }
  __device__ static void grads(const float* a, float t, const float*,
                               float* g) {
    const float p_raw = sigmoid(a[0]);
    const float p = clip(p_raw, kTiny, kPHi);
    const float r = expf(clip(a[1], kLLo, kLHi));
    const bool p_inside = p_raw > kTiny && p_raw < kPHi;
    g[0] = p_inside ? t * (1.0f - p) - r * p : 0.0f;
    const bool r_inside = a[1] > kLLo && a[1] < kLHi;
    g[1] = r_inside
               ? r * (series_digamma(t + r) - series_digamma(r) + log1pf(-p))
               : 0.0f;
  }
};

// _zip_ll / _zip_grads; heads: pi (logit), log_lambda.
struct ZeroInflatedPoisson {
  static constexpr int kHeads = 2;
  __device__ static float ll(const float* a, float t) {
    const float pi = clip(sigmoid(a[0]), kTiny, kPHi);
    const float log_lam = clip(a[1], kLLo, kLHi);
    const float lam = expf(log_lam);
    const float log_pi = logf(pi);
    const float log1m_pi = log1pf(-pi);
    const float y_pos = log1m_pi + t * log_lam - lam;
    const float y_zero = logaddexp(log_pi, log1m_pi - lam);
    return t > 0.0f ? y_pos : y_zero;
  }
  __device__ static void grads(const float* a, float t, const float*,
                               float* g) {
    const float pi_raw = sigmoid(a[0]);
    const float pi = clip(pi_raw, kTiny, kPHi);
    const float lam = expf(clip(a[1], kLLo, kLHi));
    // t = 0 branch: S = pi + (1 - pi) e^-lambda, log S via logaddexp.
    const float log_s = logaddexp(logf(pi), log1pf(-pi) - lam);
    const float inv_s = expf(-log_s);
    const float elam_over_s = expf(-lam - log_s);
    const float g_pi_zero = pi * (1.0f - pi) * (inv_s - elam_over_s);
    const float g_l_zero = -lam * (1.0f - pi) * elam_over_s;
    const bool pos = t > 0.0f;
    const bool pi_inside = pi_raw > kTiny && pi_raw < kPHi;
    const bool l_inside = a[1] > kLLo && a[1] < kLHi;
    g[0] = pi_inside ? (pos ? -pi : g_pi_zero) : 0.0f;
    g[1] = l_inside ? (pos ? t - lam : g_l_zero) : 0.0f;
  }
};

// _zinb_ll / _zinb_grads; heads: pi (logit), p (logit), log_r.
struct ZeroInflatedNegativeBinomial {
  static constexpr int kHeads = 3;
  __device__ static float ll(const float* a, float t) {
    const float pi = clip(sigmoid(a[0]), kTiny, kPHi);
    const float p = clip(sigmoid(a[1]), kTiny, kPHi);
    const float r = expf(clip(a[2], kLLo, kLHi));
    const float log_pi = logf(pi);
    const float log1m_pi = log1pf(-pi);
    const float nb_pos = series_lgamma(t + r) - series_lgamma(r) +
                         r * log1pf(-p) + t * logf(p);
    const float y_pos = log1m_pi + nb_pos;
    // NB(0) = (1 - p)^r, so log NB(0) = r log1p(-p)
    const float y_zero = logaddexp(log_pi, log1m_pi + r * log1pf(-p));
    return t > 0.0f ? y_pos : y_zero;
  }
  __device__ static void grads(const float* a, float t, const float*,
                               float* g) {
    const float pi_raw = sigmoid(a[0]);
    const float p_raw = sigmoid(a[1]);
    const float pi = clip(pi_raw, kTiny, kPHi);
    const float p = clip(p_raw, kTiny, kPHi);
    const float r = expf(clip(a[2], kLLo, kLHi));
    const float log1m_p = log1pf(-p);
    // t = 0 branch: S = pi + (1 - pi) q0 with q0 = (1 - p)^r.
    const float log_q0 = r * log1m_p;
    const float log_s = logaddexp(logf(pi), log1pf(-pi) + log_q0);
    const float inv_s = expf(-log_s);
    const float q0_over_s = expf(log_q0 - log_s);
    const float one_m_pi = 1.0f - pi;
    const float g_pi_zero = pi * one_m_pi * (inv_s - q0_over_s);
    const float g_p_zero = -one_m_pi * r * p * q0_over_s;
    const float g_r_zero = one_m_pi * r * log1m_p * q0_over_s;
    const float g_p_pos = t * (1.0f - p) - r * p;
    const float g_r_pos =
        r * (series_digamma(t + r) - series_digamma(r) + log1m_p);
    const bool pos = t > 0.0f;
    const bool pi_inside = pi_raw > kTiny && pi_raw < kPHi;
    const bool p_inside = p_raw > kTiny && p_raw < kPHi;
    const bool r_inside = a[2] > kLLo && a[2] < kLHi;
    g[0] = pi_inside ? (pos ? -pi : g_pi_zero) : 0.0f;
    g[1] = p_inside ? (pos ? g_p_pos : g_p_zero) : 0.0f;
    g[2] = r_inside ? (pos ? g_r_pos : g_r_zero) : 0.0f;
  }
};

template <class Fam>
struct Tag {
  using type = Fam;
};

// Calls fn(Tag<Fam>{}) for the family code (the order of FAMILIES in
// ops/fused_likelihood.py).
template <typename Fn>
int with_family(int family, Fn&& fn) {
  switch (family) {
    case 0: return fn(Tag<Poisson>{});
    case 1: return fn(Tag<NegativeBinomial>{});
    case 2: return fn(Tag<ZeroInflatedPoisson>{});
    case 3: return fn(Tag<ZeroInflatedNegativeBinomial>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace scvae

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
