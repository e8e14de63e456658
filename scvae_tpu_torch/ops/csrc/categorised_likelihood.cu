// K2 / K3, categorised instances: fused decoder heads + the piecewise-
// categorical ("categorised") log-likelihood, forward and backward, over a
// Poisson, negative-binomial, zero-inflated Poisson or zero-inflated NB base.
//
// Replaces the Pallas kernels of scvae_tpu/ops/fused_likelihood.py that
// _make_fused_categorised builds: _make_forward_kernel driven by
// _fused_forward (K2) and _make_backward_kernel driven by _fused_backward
// (K3), with the (ll, grads) pair _categorised_ll / _categorised_grads and
// subtract_lgamma_const=False.  For M rows of decoder output h (M, H), the
// base family's heads (W_k, b_k) and C = K + 1 class heads (W_c, b_c) stored
// class-major as one (C, H, F) weight and one (C, F) bias tensor:
//
//   a = h W + b for every head       (bf16-rounded inputs when asked, f32 sums)
//   lse = logsumexp_c a_c,  sel = a_c at c = min(t, K)
//   ll  = sel - lse + [t >= K] (base_ll(a_base, t - K) - lgamma(1 + t - K))
//   da_c = g ([min(t, K) = c] - exp(a_c - lse)),
//   da_k = g [t >= K] dbase_ll/da_k (t - K)
//   dh = sum bf16(da) W^T, dW = h^T bf16(da), db = sum_rows da  (every head)
//
// Up to 32 heads (_MAX_FUSED_HEADS): the shared-memory tiles of
// fused_heads.cuh hold 33.8 KB of weights per head, so the class heads
// stream through the tiles kClassGroup at a time; class c's weights are the
// matrix at W + c H F, indexed arithmetically, and the <= 3 base heads keep
// their compile-time pointer slots.  The forward keeps an online (max,
// sum exp) and the selected logit per element over the class loop and writes
// the element's lse (M, F) beside the row sums: the backward needs it before
// any class gradient, and reading it back costs far less than a second sweep
// over the classes.  The (M, F, C) logits never reach device memory.
//
// The backward is two deterministic passes without atomics, as for the base
// families: cat_dh_kernel (one block per 16-row tile and 256-wide dh chunk,
// looping over genes: base heads, then each class group) and cat_dw_kernel
// (one block per 16-gene tile, 256-wide dW chunk and head group, looping over
// rows: group 0 is the base heads, group z >= 1 the classes
// [4 (z - 1), 4 z)).  Each group block recomputes its own heads'
// activations only.
//
// Bound on the H100 at the headline shape (M = F = 2048, H = 256, bf16
// inputs; ZINB with K = 10, 14 heads): 2 * 14 * M * H * F = 30.1 GFLOP per
// pass (and twice that per backward pass) at 989 TFLOP/s against about 80 MB
// of h, weights, t and lse at 3.35 TB/s, so operations bound it.  This first
// version multiplies with float FMAs on the CUDA cores from shared-memory
// tiles, as the base kernels do.
//
// t is converted to float32 before any arithmetic, so bfloat16 targets
// (exact for counts <= 256) give the float32 results.

#include "count_families.cuh"

namespace scvae {
namespace {

// Class heads staged and multiplied together.
constexpr int kClassGroup = 4;

// Consecutive class heads c0, c0 + 1, ... of the class-major tensors, as a
// head source for stage_w / tile_activations: slot k reads class c0 + k, and
// slots past the last class repeat it (their values are never used), so
// every slot reads valid memory and the slot index stays compile-time.
template <typename P>
struct Slots {
  P* base;
  long long stride;
  int last;  // slots past this one read this one
  __device__ P* operator[](int k) const {
    return base + (long long)(k < last ? k : last) * stride;
  }
};

struct ClassGroup {
  Slots<const float> w, b;
  int n;  // classes in this group
};

struct ClassGrads {
  Slots<float> dw, db;
};

__device__ __forceinline__ ClassGroup class_group(const float* cw,
                                                  const float* cb, int c0,
                                                  int n_classes, int hidden,
                                                  int f) {
  const int n = min(kClassGroup, n_classes - c0);
  const long long hf = (long long)hidden * f;
  return {{cw + c0 * hf, hf, n - 1}, {cb + (long long)c0 * f, f, n - 1}, n};
}

// [min(t, K) = c] as _categorised_grads tests it: c <= t < c + 1 below K.
__device__ __forceinline__ float class_indicator(float t, int c, int k) {
  const bool hit = c < k ? (t >= (float)c && t < (float)(c + 1))
                         : t >= (float)k;
  return hit ? 1.0f : 0.0f;
}

__host__ __device__ constexpr int max_int(int a, int b) {
  return a > b ? a : b;
}

// Forward: one block per 16-row tile, looping over all genes; the row sums
// (M,) and the elements' lse (M, F).
template <class Fam, typename TT>
__global__ void __launch_bounds__(kThreads)
    cat_forward_kernel(const float* __restrict__ h, Heads base,
                       const float* __restrict__ cw,
                       const float* __restrict__ cb, int n_classes,
                       const TT* __restrict__ t, float* __restrict__ out,
                       float* __restrict__ lse_out, int m, int m_t,
                       int hidden, int f, int round_bf16) {
  constexpr int NB = Fam::kHeads;
  extern __shared__ __align__(16) float smem[];
  const int kc = chunk_width(hidden), nc = n_chunks(hidden);
  const int hs = round_up4(kc) + 4;
  const int ws = kGeneTile + 1;
  float* sH = smem;                // [16][hs]
  float* sW = sH + kRowTile * hs;  // [max(NB, 4)][kc][33]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowTile;
  const int gl = tid % kGeneTile;
  const int ty = tid / kGeneTile;
  const int rl[2] = {ty, ty + kRowTile / 2};
  const int k = n_classes - 1;

  float row_ll[2] = {0.0f, 0.0f};
  if (nc == 1) stage_h(sH, h, row0, kRowTile, m, hidden, 0, kc, hs, round_bf16);
  for (int f0 = 0; f0 < f; f0 += kGeneTile) {
    const int gene = f0 + gl;
    bool valid[2];
    float tv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + rl[i];
      valid[i] = row < m && gene < f;
      tv[i] = valid[i] ? load_f(t + (long long)(row % m_t) * f + gene) : 0.0f;
    }
    float acc[2][NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[0][j] = acc[1][j] = 0.0f;
    tile_activations<NB, kGeneTile>(sH, sW, h, base, row0, kRowTile, rl[0],
                                    rl[1], f0, gl, ws, m, hidden, f, hs, false,
                                    round_bf16, acc);

    // online (max, sum exp) and the selected logit over the classes
    float mx[2] = {0.0f, 0.0f}, sm[2] = {0.0f, 0.0f}, sel[2] = {0.0f, 0.0f};
    for (int c0 = 0; c0 < n_classes; c0 += kClassGroup) {
      const ClassGroup grp = class_group(cw, cb, c0, n_classes, hidden, f);
      float ca[2][kClassGroup];
#pragma unroll
      for (int j = 0; j < kClassGroup; ++j) ca[0][j] = ca[1][j] = 0.0f;
      tile_activations<kClassGroup, kGeneTile>(
          sH, sW, h, grp, row0, kRowTile, rl[0], rl[1], f0, gl, ws, m,
          hidden, f, hs, false, round_bf16, ca);
#pragma unroll
      for (int j = 0; j < kClassGroup; ++j) {
        const int c = c0 + j;
        if (c >= n_classes) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!valid[i]) continue;
          const float a = ca[i][j] + grp.b[j][gene];
          if (c == 0) {
            mx[i] = a;
            sm[i] = 1.0f;
            sel[i] = a;
            continue;
          }
          if (a > mx[i]) {
            sm[i] = sm[i] * expf(mx[i] - a) + 1.0f;
            mx[i] = a;
          } else {
            sm[i] += expf(a - mx[i]);
          }
          if (tv[i] >= (float)c) sel[i] = a;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!valid[i]) continue;
      const int row = row0 + rl[i];
      const float lse = mx[i] + logf(sm[i]);
      float ll = sel[i] - lse;
      if (tv[i] >= (float)k) {
        const float shifted = tv[i] - (float)k;
        float a[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) a[j] = acc[i][j] + base.b[j][gene];
        ll += Fam::ll(a, shifted) - series_lgamma(1.0f + shifted);
      }
      row_ll[i] += ll;
      lse_out[(long long)row * f + gene] = lse;
    }
  }
  write_row_sums(row_ll, rl, row0, gl, m, out);
}

// dll/da of the base heads: the base family's gradients at the shifted
// count t - K, zero below K.
template <class Fam>
struct ShiftedBaseGrads {
  int k;
  __device__ __forceinline__ void operator()(int, int, float t,
                                             const float* a, float* da) const {
    if (t >= (float)k) Fam::grads(a, t - (float)k, nullptr, da);
  }
};

// The float32 backward (the bf16 one runs on the tensor cores).
// Backward pass 1: one block per 16-row tile (blockIdx.x) and 256-wide dh
// column chunk (blockIdx.y), looping over all genes; for each gene tile the
// base heads, then each class group: activations, da into sDa, and the dh
// products with the group's weights.
template <class Fam, typename TT>
__global__ void __launch_bounds__(kThreads)
    cat_dh_kernel(const float* __restrict__ g, const float* __restrict__ h,
                  Heads base, const float* __restrict__ cw,
                  const float* __restrict__ cb, int n_classes,
                  const TT* __restrict__ t, const float* __restrict__ lse,
                  float* __restrict__ dh, int m, int m_t, int hidden, int f) {
  constexpr bool round_bf16 = false;  // bf16: categorised_likelihood_tc.cu
  constexpr int NB = Fam::kHeads;
  constexpr int NS = max_int(NB, kClassGroup);
  extern __shared__ __align__(16) float smem[];
  const int kc = chunk_width(hidden), nc = n_chunks(hidden);
  const int hs = round_up4(kc) + 4;
  const int ws = kGeneTile + 1;
  float* sH = smem;                           // [16][hs]
  float* sW = sH + kRowTile * hs;             // [NS][kc][33]
  float* sDa = sW + round_up4(NS * kc * ws);  // [NS][32][16]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowTile;
  const int gl = tid % kGeneTile;
  const int ty = tid / kGeneTile;
  const int rl[2] = {ty, ty + kRowTile / 2};
  const int cy = blockIdx.y;
  const int cwy = min(kChunk, hidden - cy * kChunk);
  const bool restage = nc > 1 && cy != nc - 1;
  const int k = n_classes - 1;

  float grow[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row0 + rl[i] < m) grow[i] = g[row0 + rl[i]];
  float acc_h[kRowTile];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) acc_h[r] = 0.0f;

  if (nc == 1) stage_h(sH, h, row0, kRowTile, m, hidden, 0, kc, hs, round_bf16);
  for (int f0 = 0; f0 < f; f0 += kGeneTile) {
    const int gene = f0 + gl;
    bool valid[2];
    float tv[2], lv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + rl[i];
      valid[i] = row < m && gene < f;
      tv[i] = valid[i] ? load_f(t + (long long)(row % m_t) * f + gene) : 0.0f;
      lv[i] = valid[i] ? lse[(long long)row * f + gene] : 0.0f;
    }

    // base heads: gradients masked to t >= K at the shifted count
    float acc[2][NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[0][j] = acc[1][j] = 0.0f;
    tile_activations<NB, kGeneTile>(sH, sW, h, base, row0, kRowTile, rl[0],
                                    rl[1], f0, gl, ws, m, hidden, f, hs, false,
                                    round_bf16, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float da[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) da[j] = 0.0f;
      if (valid[i]) {
        float a[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) a[j] = acc[i][j] + base.b[j][gene];
        ShiftedBaseGrads<Fam>{k}(row0 + rl[i], gene, tv[i], a, da);
#pragma unroll
        for (int j = 0; j < NB; ++j) da[j] *= grow[i];
      }
      store_da<NB>(sDa, gl, rl[i], da, round_bf16);
    }
    dh_tile<NB>(sDa, sW, base, f0, ws, cy, cwy, f, restage, round_bf16, acc_h);

    // class heads, a group at a time
    for (int c0 = 0; c0 < n_classes; c0 += kClassGroup) {
      const ClassGroup grp = class_group(cw, cb, c0, n_classes, hidden, f);
      float ca[2][kClassGroup];
#pragma unroll
      for (int j = 0; j < kClassGroup; ++j) ca[0][j] = ca[1][j] = 0.0f;
      // (its leading __syncthreads also ends the last dh products' reads)
      tile_activations<kClassGroup, kGeneTile>(
          sH, sW, h, grp, row0, kRowTile, rl[0], rl[1], f0, gl, ws, m,
          hidden, f, hs, false, round_bf16, ca);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float da[kClassGroup];
#pragma unroll
        for (int j = 0; j < kClassGroup; ++j) {
          da[j] = 0.0f;
          if (valid[i] && j < grp.n) {
            const float a = ca[i][j] + grp.b[j][gene];
            da[j] = grow[i] * (class_indicator(tv[i], c0 + j, k) -
                               expf(a - lv[i]));
          }
        }
        store_da<kClassGroup>(sDa, gl, rl[i], da, round_bf16);
      }
      dh_tile<kClassGroup>(sDa, sW, grp, f0, ws, cy, cwy, f, restage,
                           round_bf16, acc_h);
    }
  }
  write_dh(acc_h, row0, cy, cwy, m, hidden, dh);
}

// dll/da_c of the group's classes c0 ... c0 + n - 1 from the element's lse.
struct ClassGroupGrads {
  const float* lse;
  int f, c0, n, k;
  __device__ __forceinline__ void operator()(int row, int gene, float t,
                                             const float* a, float* da) const {
    const float lv = lse[(long long)row * f + gene];
#pragma unroll
    for (int j = 0; j < kClassGroup; ++j)
      if (j < n) da[j] = class_indicator(t, c0 + j, k) - expf(a[j] - lv);
  }
};

// Backward pass 2 (dw_body of fused_heads.cuh over one head group):
// blockIdx.z = 0 for the base heads, z >= 1 for the class group starting at
// class 4 (z - 1).  Each group block recomputes its own heads' activations.
// Two blocks per SM below three base heads: left to itself ptxas gives
// those instances 176 registers and one block, and Poisson-cat's pass then
// ran 1.3x slower on the H100 than at 128 registers with a few spills.
template <class Fam, typename TT>
__global__ void __launch_bounds__(kThreads, Fam::kHeads < 3 ? 2 : 1)
    cat_dw_kernel(const float* __restrict__ g, const float* __restrict__ h,
                  Heads base, const float* __restrict__ cw,
                  const float* __restrict__ cb, int n_classes,
                  const TT* __restrict__ t, const float* __restrict__ lse,
                  HeadGrads base_out, float* __restrict__ dcw,
                  float* __restrict__ dcb, int m, int m_t, int hidden, int f) {
  constexpr bool round_bf16 = false;  // bf16: categorised_likelihood_tc.cu
  const int k = n_classes - 1;
  if (blockIdx.z == 0) {
    dw_body<Fam::kHeads>(g, h, base, t, base_out, Fam::kHeads, m, m_t, hidden,
                         f, round_bf16, ShiftedBaseGrads<Fam>{k});
    return;
  }
  const int c0 = (blockIdx.z - 1) * kClassGroup;
  const ClassGroup grp = class_group(cw, cb, c0, n_classes, hidden, f);
  const long long hf = (long long)hidden * f;
  const ClassGrads out{{dcw + c0 * hf, hf, grp.n - 1},
                       {dcb + (long long)c0 * f, f, grp.n - 1}};
  dw_body<kClassGroup>(g, h, grp, t, out, grp.n, m, m_t, hidden, f,
                       round_bf16, ClassGroupGrads{lse, f, c0, grp.n, k});
}

// Dynamic shared memory of each kernel, bounded for any H: at most 160,000
// bytes (the dh pass with four weight slots) of the 232,448 a block may use.
size_t cat_row_smem(int hidden, int slots, bool dh) {
  const int kc = chunk_width(hidden);
  const size_t floats = (size_t)kRowTile * (round_up4(kc) + 4) +
                        round_up4(slots * kc * (kGeneTile + 1)) +
                        (dh ? slots * kGeneTile * kRowTile : 0);
  return floats * sizeof(float);
}

size_t cat_dw_smem(int hidden, int slots) {
  const int kc = chunk_width(hidden);
  const size_t floats = (size_t)kDwRowTile * (round_up4(kc) + 4) +
                        round_up4(slots * kc * kDwGeneTile) +
                        slots * kDwRowTile * kDwGeneTile +
                        slots * kDwGeneTile * kDwGeneTile;
  return floats * sizeof(float);
}

template <class Fam>
constexpr int slots() {
  return max_int(Fam::kHeads, kClassGroup);
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB,
// 2 = ZIP, 3 = ZINB (the base); its head k's weights are wk, bk (null past
// the family's heads).  cw (C, H, F) and cb (C, F) hold the n_classes = C =
// K + 1 class heads.  t_dtype: 0 = float32, 1 = bfloat16.  h rows cycle over
// the m_t rows of t (m % m_t == 0); lse is (M, F).

int scvae_cat_forward(int family, const float* h, const float* w0,
                      const float* b0, const float* w1, const float* b1,
                      const float* w2, const float* b2, const float* cw,
                      const float* cb, int n_classes, const void* t,
                      int t_dtype, float* out, float* lse, int m, int m_t,
                      int hidden, int f, int round_bf16, void* stream) {
  if (m == 0) return 0;
  if (n_classes < 2) return (int)cudaErrorInvalidValue;
  const Heads base{{w0, w1, w2}, {b0, b1, b2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      using TT = decltype(tt);
      const size_t bytes = cat_row_smem(hidden, slots<Fam>(), false);
      auto kernel = cat_forward_kernel<Fam, TT>;
      if (int err = set_smem(kernel, bytes)) return err;
      const dim3 grid((m + kRowTile - 1) / kRowTile);
      kernel<<<grid, kThreads, bytes, s>>>(
          h, base, cw, cb, n_classes, static_cast<const TT*>(t), out, lse, m,
          m_t, hidden, f, round_bf16);
      return (int)cudaGetLastError();
    });
  });
}

int scvae_cat_backward_dh(int family, const float* g, const float* h,
                          const float* w0, const float* b0, const float* w1,
                          const float* b1, const float* w2, const float* b2,
                          const float* cw, const float* cb, int n_classes,
                          const void* t, int t_dtype, const float* lse,
                          float* dh, int m, int m_t, int hidden, int f,
                          void* stream) {
  if (m == 0) return 0;
  if (n_classes < 2) return (int)cudaErrorInvalidValue;
  const Heads base{{w0, w1, w2}, {b0, b1, b2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      using TT = decltype(tt);
      const size_t bytes = cat_row_smem(hidden, slots<Fam>(), true);
      auto kernel = cat_dh_kernel<Fam, TT>;
      if (int err = set_smem(kernel, bytes)) return err;
      const dim3 grid((m + kRowTile - 1) / kRowTile, n_chunks(hidden));
      kernel<<<grid, kThreads, bytes, s>>>(
          g, h, base, cw, cb, n_classes, static_cast<const TT*>(t), lse, dh,
          m, m_t, hidden, f);
      return (int)cudaGetLastError();
    });
  });
}

int scvae_cat_backward_dw(int family, const float* g, const float* h,
                          const float* w0, const float* b0, const float* w1,
                          const float* b1, const float* w2, const float* b2,
                          const float* cw, const float* cb, int n_classes,
                          const void* t, int t_dtype, const float* lse,
                          float* dw0, float* db0, float* dw1, float* db1,
                          float* dw2, float* db2, float* dcw, float* dcb,
                          int m, int m_t, int hidden, int f, void* stream) {
  if (f == 0) return 0;
  if (n_classes < 2) return (int)cudaErrorInvalidValue;
  const Heads base{{w0, w1, w2}, {b0, b1, b2}};
  const HeadGrads base_out{{dw0, dw1, dw2}, {db0, db1, db2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      using TT = decltype(tt);
      const size_t bytes = cat_dw_smem(hidden, slots<Fam>());
      auto kernel = cat_dw_kernel<Fam, TT>;
      if (int err = set_smem(kernel, bytes)) return err;
      const int groups = 1 + (n_classes + kClassGroup - 1) / kClassGroup;
      const dim3 grid((f + kDwGeneTile - 1) / kDwGeneTile, n_chunks(hidden),
                      groups);
      kernel<<<grid, kThreads, bytes, s>>>(
          g, h, base, cw, cb, n_classes, static_cast<const TT*>(t), lse,
          base_out, dcw, dcb, m, m_t, hidden, f);
      return (int)cudaGetLastError();
    });
  });
}

}  // extern "C"
