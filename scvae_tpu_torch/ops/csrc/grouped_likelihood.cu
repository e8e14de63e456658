// K4 / K5: the grouped fused likelihood, forward and backward, for the
// Poisson, negative-binomial, zero-inflated Poisson and zero-inflated NB
// families.
//
// Replaces the Pallas kernels of scvae_tpu/ops/fused_likelihood.py:
// _make_grouped_forward_kernel driven by _grouped_forward (K4) and
// _make_grouped_backward_kernel driven by _grouped_backward (K5), built by
// _make_fused_grouped with the families' (ll, grads) pairs and
// subtract_lgamma_const=True.  G groups of decoder output h (G, M, H) - the
// GMVAE's K·S cluster-sample groups - share one block of targets t (M, F):
//
//   a_k = h_g W_k + b_k                 (bf16-rounded inputs when asked, f32 sums)
//   ll[g, i] = sum_f log p(t_i | a) - lgamma(1 + t_i)      (always subtracted)
//   da_k = g[g, i] * dll/da_k            (zero outside each clip range)
//   dh_g = sum_k bf16(da_k) W_k^T,  dW_k = sum_g h_g^T bf16(da_k),
//   db_k = sum_g sum_rows da_k           (unrounded)
//
// What a group loop buys: the flat CUDA-core kernels (row_tile_kernel of
// fused_heads.cuh) give each block 16 rows and stream every head's (H x 32)
// weight tile through shared memory for each of its gene tiles, so K·S·B
// decoder rows stage the weights K·S times per target row tile.  Here a block owns 16 target rows; for each
// gene tile it stages the weights (and reads t, and computes lgamma(1 + t))
// once and runs the groups against them, staging one group's (16 x H) h tile
// at a time, 256 hidden units per chunk.  Shared memory never depends on G:
//
// * grouped_forward_kernel runs all G groups per gene tile and adds each
//   group's row partial sums (reduced across the warp in a fixed order) to
//   out (G, M), which only this block writes;
// * grouped_dh_kernel runs kGroupTile groups per block (blockIdx.z), their
//   (16 x 256) dh accumulators kept in shared memory, so a launch stages
//   the weights ceil(G / kGroupTile) times per row tile;
// * grouped_dw_kernel is dw_body (fused_heads.cuh) over the group-major
//   rows g * M + i of h, whose targets are the rows i = row % M: it stages
//   the weights once per block and sums over groups, then rows, in a fixed
//   order without atomics - the flat dW pass's work over G·M rows.
//
// For H > 256 the hidden chunks of W are restaged for each group, as the
// flat kernels restage them for each row tile.
//
// Bound on the H100 at the GMVAE's shape (G = 10, M = F = 2048, H = 256,
// bf16 inputs; NB's two heads): 2 * 2 * G * M * H * F = 42.9 GFLOP per
// product at 989 TFLOP/s, 0.0434 ms, above the bytes (h 21 MB, W 4 MB, t
// 8 MB) at 3.35 TB/s; two products per backward pass.  Like the flat
// kernels, this first version multiplies with float FMAs on the CUDA cores.

#include "count_families.cuh"

namespace scvae {
namespace {

// Groups of one dh block, each with a (16 x 256) float accumulator in
// shared memory (64 KB for four).
constexpr int kGroupTile = 4;

// Activations of the block's rows r0, r1 of group h_g at gene column gc:
// h_g staged chunk by chunk; the weights too when there is more than one
// chunk (for one chunk the caller staged them for the whole gene tile).
template <int NH>
__device__ __forceinline__ void group_activations(
    float* sH, float* sW, const float* __restrict__ h_g, const Heads& heads,
    int row0, int r0, int r1, int f0, int gc, int ws, int m, int hidden,
    int f, int hs, bool round_bf16, float acc[2][NH]) {
  const int nc = n_chunks(hidden);
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * kChunk, cw = min(kChunk, hidden - c0);
    __syncthreads();  // readers of the previous sH / sW contents are done
    stage_h(sH, h_g, row0, kRowTile, m, hidden, c0, cw, hs, round_bf16);
    if (nc > 1)
      stage_w<NH, kGeneTile>(sW, heads, f0, ws, c0, cw, f, round_bf16);
    __syncthreads();
    head_products<NH>(sH, sW, r0, r1, gc, hs, ws, cw, acc);
  }
}

// The gene tile's weights, staged once for every group of the block when
// they fit in one hidden chunk.
template <int NH>
__device__ __forceinline__ void stage_tile_weights(float* sW,
                                                   const Heads& heads, int f0,
                                                   int ws, int hidden, int f,
                                                   bool round_bf16) {
  if (n_chunks(hidden) != 1) return;
  __syncthreads();  // the last gene tile's readers of sW are done
  stage_w<NH, kGeneTile>(sW, heads, f0, ws, 0, hidden, f, round_bf16);
}

// K4: one block per 16 target rows, looping over genes, then groups.
// Thread layout as row_tile_kernel: gene column tid % 32, rows tid / 32 and
// that + 8.
template <class Fam, typename TT>
__global__ void __launch_bounds__(kThreads)
    grouped_forward_kernel(const float* __restrict__ h, Heads heads,
                           const TT* __restrict__ t, float* __restrict__ out,
                           int n_groups, int m, int hidden, int f,
                           int round_bf16) {
  constexpr int NH = Fam::kHeads;
  extern __shared__ __align__(16) float smem[];
  const int kc = chunk_width(hidden);
  const int hs = round_up4(kc) + 4;
  const int ws = kGeneTile + 1;
  float* sH = smem;                // [16][hs]
  float* sW = sH + kRowTile * hs;  // [NH][kc][33]

  const int row0 = blockIdx.x * kRowTile;
  const int gl = threadIdx.x % kGeneTile;
  const int ty = threadIdx.x / kGeneTile;
  const int rl[2] = {ty, ty + kRowTile / 2};
  const long long group_stride = (long long)m * hidden;

  for (int f0 = 0; f0 < f; f0 += kGeneTile) {
    const int gene = f0 + gl;
    bool valid[2];
    float tv[2], lgamma_t[2], bias[NH];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + rl[i];
      valid[i] = row < m && gene < f;
      tv[i] = valid[i] ? load_f(t + (long long)row * f + gene) : 0.0f;
      lgamma_t[i] = valid[i] ? series_lgamma(1.0f + tv[i]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NH; ++k) bias[k] = gene < f ? heads.b[k][gene] : 0.0f;
    stage_tile_weights<NH>(sW, heads, f0, ws, hidden, f, round_bf16);

    for (int grp = 0; grp < n_groups; ++grp) {
      float acc[2][NH];
#pragma unroll
      for (int k = 0; k < NH; ++k) acc[0][k] = acc[1][k] = 0.0f;
      group_activations<NH>(sH, sW, h + grp * group_stride, heads, row0,
                            rl[0], rl[1], f0, gl, ws, m, hidden, f, hs,
                            round_bf16, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ll = 0.0f;
        if (valid[i]) {
          float a[NH];
#pragma unroll
          for (int k = 0; k < NH; ++k) a[k] = acc[i][k] + bias[k];
          ll = Fam::ll(a, tv[i]) - lgamma_t[i];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ll += __shfl_xor_sync(0xffffffffu, ll, off);
        const int row = row0 + rl[i];
        if (gl == 0 && row < m) {
          float* o = out + (long long)grp * m + row;
          *o = (f0 == 0 ? 0.0f : *o) + ll;
        }
      }
    }
  }
}

// K5, pass 1: one block per 16 target rows (blockIdx.x), 256-wide dh column
// chunk (blockIdx.y) and kGroupTile groups (blockIdx.z), looping over genes,
// then the block's groups.  Thread tid owns dh column cy * 256 + tid of
// each row; its running sums for group j sit at sAcc[j][row][tid].
template <class Fam, typename TT>
__global__ void __launch_bounds__(kThreads)
    grouped_dh_kernel(const float* __restrict__ g,
                      const float* __restrict__ h, Heads heads,
                      const TT* __restrict__ t, float* __restrict__ dh,
                      int n_groups, int m, int hidden, int f,
                      int round_bf16) {
  constexpr int NH = Fam::kHeads;
  extern __shared__ __align__(16) float smem[];
  const int kc = chunk_width(hidden), nc = n_chunks(hidden);
  const int hs = round_up4(kc) + 4;
  const int ws = kGeneTile + 1;
  float* sH = smem;                           // [16][hs]
  float* sW = sH + kRowTile * hs;             // [NH][kc][33]
  float* sDa = sW + round_up4(NH * kc * ws);  // [NH][32][16]
  float* sAcc = sDa + NH * kGeneTile * kRowTile;  // [kGroupTile][16][kc]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowTile;
  const int gl = tid % kGeneTile;
  const int ty = tid / kGeneTile;
  const int rl[2] = {ty, ty + kRowTile / 2};
  const int cy = blockIdx.y;
  const int cwy = min(kChunk, hidden - cy * kChunk);
  const bool restage = nc > 1 && cy != nc - 1;
  const int grp0 = blockIdx.z * kGroupTile;
  const int ng = min(kGroupTile, n_groups - grp0);
  const long long group_stride = (long long)m * hidden;

  if (tid < cwy)
    for (int i = 0; i < ng * kRowTile; ++i) sAcc[i * kc + tid] = 0.0f;

  for (int f0 = 0; f0 < f; f0 += kGeneTile) {
    const int gene = f0 + gl;
    bool valid[2];
    float tv[2], bias[NH];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + rl[i];
      valid[i] = row < m && gene < f;
      tv[i] = valid[i] ? load_f(t + (long long)row * f + gene) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NH; ++k) bias[k] = gene < f ? heads.b[k][gene] : 0.0f;
    stage_tile_weights<NH>(sW, heads, f0, ws, hidden, f, round_bf16);

    for (int j = 0; j < ng; ++j) {
      const int grp = grp0 + j;
      float acc[2][NH];
#pragma unroll
      for (int k = 0; k < NH; ++k) acc[0][k] = acc[1][k] = 0.0f;
      // (its leading __syncthreads also ends the last group's dh products)
      group_activations<NH>(sH, sW, h + grp * group_stride, heads, row0,
                            rl[0], rl[1], f0, gl, ws, m, hidden, f, hs,
                            round_bf16, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float da[NH];
#pragma unroll
        for (int k = 0; k < NH; ++k) da[k] = 0.0f;
        if (valid[i]) {
          float a[NH];
#pragma unroll
          for (int k = 0; k < NH; ++k) a[k] = acc[i][k] + bias[k];
          Fam::grads(a, tv[i], nullptr, da);
          const float gv = g[(long long)grp * m + row0 + rl[i]];
#pragma unroll
          for (int k = 0; k < NH; ++k) da[k] *= gv;
        }
        store_da<NH>(sDa, gl, rl[i], da, round_bf16);
      }
      float acc_h[kRowTile];
      float* slot = sAcc + (long long)j * kRowTile * kc + tid;
#pragma unroll
      for (int r = 0; r < kRowTile; ++r)
        acc_h[r] = tid < cwy ? slot[r * kc] : 0.0f;
      dh_tile<NH>(sDa, sW, heads, f0, ws, cy, cwy, f, restage, round_bf16,
                  acc_h);
      if (tid < cwy) {
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) slot[r * kc] = acc_h[r];
      }
    }
  }

  for (int j = 0; j < ng; ++j) {
    float acc_h[kRowTile];
    const float* slot = sAcc + (long long)j * kRowTile * kc + tid;
#pragma unroll
    for (int r = 0; r < kRowTile; ++r)
      acc_h[r] = tid < cwy ? slot[r * kc] : 0.0f;
    write_dh(acc_h, row0, cy, cwy, m, hidden,
             dh + (grp0 + j) * group_stride);
  }
}

// K5, pass 2: dw_body over the G·M group-major rows g·M + i of h and of the
// row cotangents, whose targets are the rows i = row % M of t.  One block per
// 16 genes (and 256-wide row chunk of dW) stages that gene tile's weights
// once and walks the groups in order, each group's rows in tiles of 32: dW
// and db sum over groups, then rows, in a fixed order, without atomics.
template <class Fam, typename TT>
__global__ void __launch_bounds__(kThreads)
    grouped_dw_kernel(const float* __restrict__ g, const float* __restrict__ h,
                      Heads heads, const TT* __restrict__ t, HeadGrads out,
                      int n_groups, int m, int hidden, int f,
                      int round_bf16) {
  const RowExtras none{nullptr, nullptr};
  dw_body<Fam::kHeads>(g, h, heads, t, out, Fam::kHeads, n_groups * m, m,
                       hidden, f, round_bf16, FamilyGrads<Fam>{none, m});
}

// Dynamic shared memory, bounded for any G and H: at most (16 * 260 +
// 3 * 256 * 33) floats = 118,016 bytes (forward, three heads) and that plus
// (3 * 512 + 4 * 16 * 256) floats = 189,696 bytes (dh pass) of the 232,448 a
// block may use.
template <int NH>
size_t grouped_smem(int hidden, bool dh) {
  const int kc = chunk_width(hidden);
  size_t floats = (size_t)kRowTile * (round_up4(kc) + 4) +
                  round_up4(NH * kc * (kGeneTile + 1));
  if (dh) floats += NH * kGeneTile * kRowTile + kGroupTile * kRowTile * kc;
  return floats * sizeof(float);
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB,
// 2 = ZIP, 3 = ZINB; head k's weights are wk, bk (null past the family's
// heads).  t_dtype: 0 = float32, 1 = bfloat16.  h is (n_groups, m, hidden)
// and g, out are (n_groups, m), group-major; t is (m, f).

int scvae_grouped_forward(int family, const float* h, const float* w0,
                          const float* b0, const float* w1, const float* b1,
                          const float* w2, const float* b2, const void* t,
                          int t_dtype, float* out, int n_groups, int m,
                          int hidden, int f, int round_bf16, void* stream) {
  if (n_groups == 0 || m == 0 || f == 0) return 0;
  const Heads heads{{w0, w1, w2}, {b0, b1, b2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      using TT = decltype(tt);
      const size_t bytes = grouped_smem<Fam::kHeads>(hidden, false);
      auto kernel = grouped_forward_kernel<Fam, TT>;
      if (int err = set_smem(kernel, bytes)) return err;
      const dim3 grid((m + kRowTile - 1) / kRowTile);
      kernel<<<grid, kThreads, bytes, s>>>(h, heads, static_cast<const TT*>(t),
                                           out, n_groups, m, hidden, f,
                                           round_bf16);
      return (int)cudaGetLastError();
    });
  });
}

int scvae_grouped_backward_dh(int family, const float* g, const float* h,
                              const float* w0, const float* b0,
                              const float* w1, const float* b1,
                              const float* w2, const float* b2, const void* t,
                              int t_dtype, float* dh, int n_groups, int m,
                              int hidden, int f, int round_bf16,
                              void* stream) {
  if (n_groups == 0 || m == 0) return 0;
  const Heads heads{{w0, w1, w2}, {b0, b1, b2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      using TT = decltype(tt);
      const size_t bytes = grouped_smem<Fam::kHeads>(hidden, true);
      auto kernel = grouped_dh_kernel<Fam, TT>;
      if (int err = set_smem(kernel, bytes)) return err;
      const dim3 grid((m + kRowTile - 1) / kRowTile, n_chunks(hidden),
                      (n_groups + kGroupTile - 1) / kGroupTile);
      kernel<<<grid, kThreads, bytes, s>>>(g, h, heads,
                                           static_cast<const TT*>(t), dh,
                                           n_groups, m, hidden, f, round_bf16);
      return (int)cudaGetLastError();
    });
  });
}

int scvae_grouped_backward_dw(int family, const float* g, const float* h,
                              const float* w0, const float* b0,
                              const float* w1, const float* b1,
                              const float* w2, const float* b2, const void* t,
                              int t_dtype, float* dw0, float* db0, float* dw1,
                              float* db1, float* dw2, float* db2,
                              int n_groups, int m, int hidden, int f,
                              int round_bf16, void* stream) {
  if (f == 0) return 0;
  const Heads heads{{w0, w1, w2}, {b0, b1, b2}};
  const HeadGrads out{{dw0, dw1, dw2}, {db0, db1, db2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return with_t_type(t_dtype, [&](auto tt) {
      using TT = decltype(tt);
      const size_t bytes = dw_smem<Fam::kHeads>(hidden);
      auto kernel = grouped_dw_kernel<Fam, TT>;
      if (int err = set_smem(kernel, bytes)) return err;
      const dim3 grid((f + kDwGeneTile - 1) / kDwGeneTile, n_chunks(hidden));
      kernel<<<grid, kThreads, bytes, s>>>(g, h, heads,
                                           static_cast<const TT*>(t), out,
                                           n_groups, m, hidden, f, round_bf16);
      return (int)cudaGetLastError();
    });
  });
}

}  // extern "C"
