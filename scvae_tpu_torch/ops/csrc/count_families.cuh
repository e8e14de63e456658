// The base count families of the fused likelihood kernels: the CUDA twins
// of the (ll, grads) pairs _BASE_LL / _BASE_GRADS of
// scvae_tpu/ops/fused_likelihood.py, shared by the base kernels K2/K3
// (count_likelihood_tc.cu), their grouped instances K4/K5
// (grouped_likelihood_tc.cu) and their categorised instances
// (categorised_likelihood_tc.cu).
//
// A family is a struct with
//   static constexpr int kHeads;                       // dense heads, <= 3
//   static float ll(const float* a, float t);          // log p(t | a)
//   static void grads(const float* a, float t, const float*, float* g);
// where a holds the kHeads activations a_k = h W_k + b_k of one (row,
// gene) and g receives d ll / d a_k (zero outside each clip range).
//
// Transcendentals use the shift-3 series of special.cuh and the clip
// constants of the reference (_TINY, _P_HI, _L_LO, _L_HI).  Clips propagate
// NaN like jnp.clip.  The zero-inflated families evaluate both branches and
// select on t > 0, as jnp.where does, so a non-finite value of the branch not
// taken never reaches the result.
#pragma once

#include <cuda_runtime.h>

#include "special.cuh"

namespace scvae {
namespace {

constexpr float kTiny = 0x1p-126f;      // np.finfo(np.float32).tiny
constexpr float kPHi = 0x1.fffffep-1f;  // nextafter(1, 0)
constexpr float kLLo = -0x1.3ffffep+3f;  // nextafter(-10, +inf)
constexpr float kLHi = 0x1.3ffffep+3f;  // nextafter(10, -inf)

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // NaN passes through, as jnp.clip
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// jnp.logaddexp: NaN or same-signed infinities give x + y.
__device__ __forceinline__ float logaddexp(float x, float y) {
  const float delta = x - y;
  return isnan(delta) ? x + y : fmaxf(x, y) + log1pf(expf(-fabsf(delta)));
}

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
