// K6 / K7: fused constrained-Poisson head + log-likelihood, forward and
// backward.
//
// Replaces _cp_fused_forward (K6) and _cp_fused_backward (K7) of
// scvae_tpu/ops/fused_likelihood.py.  One head, lambda, with W (H, F) and
// b (F,); rate = softmax_F(a) n for the row's count sum n, so with
// lse = logsumexp_F(a):
//
//   a   = h W + b                     (float32; h holds bf16 values when
//                                      training in bf16, W stays float32)
//   ll  = sum_f (t a - lgamma(1 + t)) - (sum_f t)(lse - log n) - n
//   da  = g (t - (sum_f t) exp(a - lse))
//   dh  = da W^T,  dW = h^T da,  db = sum_rows da      (no rounding)
//
// The gene-axis softmax couples every gene of a row.  The TPU kernel carries
// a running (max, sumexp) across its sequential gene-tile grid axis; here one
// block owns whole rows and loops over the genes (cp_forward_kernel): each
// thread keeps an online (max, sumexp) with sum(t a - lgamma(1 + t)) and
// sum(t) for its gene column, and the 32 lanes of a warp, which hold the same
// row, merge in a fixed butterfly order with
// (m, s) + (m', s') = (M, s e^(m - M) + s' e^(m' - M)).  The forward writes
// ll and lse, which the backward reuses.  Genes past F are masked, so no
// padding reaches the sums or the lse.
//
// K7 is the two backward passes of fused_heads.cuh (a dh pass over row tiles,
// a dW / db pass over gene tiles), instantiated for the ConstrainedPoisson
// family below; the bias is added in the kernel, not carried as a constant-1
// column of h.
//
// Bound on the H100 at the headline shape (M = F = 2048, H = 256): the head
// product multiplies float32 weights, so against the 67 TFLOP/s float32 rate
// outside the tensor cores K6 does 2 M H F = 2.15 GFLOP, about 32 us, bound
// by operations (its 12.6 MB would take 3.8 us); each K7 pass recomputes the
// activations and adds one product, 4.3 GFLOP, about 64 us.

#include <math.h>

#include "fused_heads.cuh"

namespace scvae {
namespace {

struct ConstrainedPoisson {
  static constexpr int kHeads = 1;
  // extra = {lse of the row, sum of the row's targets}
  __device__ static void grads(const float* a, float t, const float* extra,
                               float* g) {
    g[0] = t - extra[1] * expf(a[0] - extra[0]);
  }
};

// (m, s) <- (m, s) + (m2, s2) for running (max, sum of exp(x - max)); an
// empty side has m = -inf and s = 0.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

// One block per tile of kRowTile rows, looping over all genes in tiles of
// kGeneTile; thread layout as row_tile_kernel.
template <typename TT>
__global__ void __launch_bounds__(kThreads)
    cp_forward_kernel(const float* __restrict__ h, Heads heads,
                      const TT* __restrict__ t, const float* __restrict__ n,
                      float* __restrict__ ll_out, float* __restrict__ lse_out,
                      int m, int m_t, int hidden, int f) {
  extern __shared__ __align__(16) float smem[];
  const int kc = chunk_width(hidden), nc = n_chunks(hidden);
  const int hs = round_up4(kc) + 4;
  const int ws = kGeneTile + 1;
  float* sH = smem;                // [16][hs]
  float* sW = sH + kRowTile * hs;  // [kc][33]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowTile;
  const int gl = tid % kGeneTile;
  const int ty = tid / kGeneTile;
  const int rl[2] = {ty, ty + kRowTile / 2};

  float mx[2] = {-INFINITY, -INFINITY};
  float se[2] = {0.0f, 0.0f};
  float acc_ll[2] = {0.0f, 0.0f};
  float sx[2] = {0.0f, 0.0f};

  if (nc == 1) stage_h(sH, h, row0, kRowTile, m, hidden, 0, kc, hs, false);
  for (int f0 = 0; f0 < f; f0 += kGeneTile) {
    float acc[2][1] = {{0.0f}, {0.0f}};
    tile_activations<1, kGeneTile>(sH, sW, h, heads, row0, kRowTile, rl[0],
                                   rl[1], f0, gl, ws, m, hidden, f, hs, false,
                                   false, acc);
    const int gene = f0 + gl;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + rl[i];
      if (row < m && gene < f) {
        const float a = acc[i][0] + heads.b[0][gene];
        const float tv = load_f(t + (long long)(row % m_t) * f + gene);
        if (a > mx[i]) {
          se[i] = se[i] * expf(mx[i] - a) + 1.0f;
          mx[i] = a;
        } else {
          se[i] += expf(a - mx[i]);
        }
        acc_ll[i] += tv * a - series_lgamma(1.0f + tv);
        sx[i] += tv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, se[i], off);
      lse_merge(mx[i], se[i], m2, s2);
      acc_ll[i] += __shfl_xor_sync(0xffffffffu, acc_ll[i], off);
      sx[i] += __shfl_xor_sync(0xffffffffu, sx[i], off);
    }
    const int row = row0 + rl[i];
    if (gl == 0 && row < m) {
      const float lse = mx[i] + logf(se[i]);
      const float nv = n[row];
      lse_out[row] = lse;
      ll_out[row] = acc_ll[i] - sx[i] * (lse - logf(nv)) - nv;
    }
  }
}

template <typename TT>
int launch_cp_forward(const float* h, Heads heads, const void* t,
                      const float* n, float* ll, float* lse, int m, int m_t,
                      int hidden, int f, cudaStream_t stream) {
  const size_t bytes = row_tile_smem<1>(hidden);
  auto kernel = cp_forward_kernel<TT>;
  if (int err = set_smem(kernel, bytes)) return err;
  const int blocks = (m + kRowTile - 1) / kRowTile;
  kernel<<<blocks, kThreads, bytes, stream>>>(
      h, heads, static_cast<const TT*>(t), n, ll, lse, m, m_t, hidden, f);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  t_dtype: 0 = float32,
// 1 = bfloat16.  h rows cycle over the m_t rows of t (m % m_t == 0); n, lse
// are per h row (m,), sx per t row (m_t,).

int scvae_cp_forward(const float* h, const float* w, const float* b,
                     const void* t, int t_dtype, const float* n, float* ll,
                     float* lse, int m, int m_t, int hidden, int f,
                     void* stream) {
  if (m == 0) return 0;
  const Heads heads{{w, nullptr, nullptr}, {b, nullptr, nullptr}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_t_type(t_dtype, [&](auto tt) {
    return launch_cp_forward<decltype(tt)>(h, heads, t, n, ll, lse, m, m_t,
                                           hidden, f, s);
  });
}

int scvae_cp_backward_dh(const float* g, const float* h, const float* w,
                         const float* b, const void* t, int t_dtype,
                         const float* lse, const float* sx, float* dh, int m,
                         int m_t, int hidden, int f, void* stream) {
  if (m == 0) return 0;
  const Heads heads{{w, nullptr, nullptr}, {b, nullptr, nullptr}};
  const RowExtras extras{lse, sx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_t_type(t_dtype, [&](auto tt) {
    return launch_row_tile<ConstrainedPoisson, decltype(tt), true>(
        g, h, heads, extras, t, dh, m, m_t, hidden, f, 0, 0, s);
  });
}

int scvae_cp_backward_dw(const float* g, const float* h, const float* w,
                         const float* b, const void* t, int t_dtype,
                         const float* lse, const float* sx, float* dw,
                         float* db, int m, int m_t, int hidden, int f,
                         void* stream) {
  if (f == 0) return 0;
  const Heads heads{{w, nullptr, nullptr}, {b, nullptr, nullptr}};
  const HeadGrads out{{dw, nullptr, nullptr}, {db, nullptr, nullptr}};
  const RowExtras extras{lse, sx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_t_type(t_dtype, [&](auto tt) {
    return launch_dw<ConstrainedPoisson, decltype(tt)>(
        g, h, heads, extras, t, out, m, m_t, hidden, f, 0, s);
  });
}

}  // extern "C"
