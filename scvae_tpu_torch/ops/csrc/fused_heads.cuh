// Shared machinery of the fused decoder-head likelihood kernels on the CUDA
// cores (K6/K7 of float32 h in cp_likelihood.cu; the grouped K4/K5 and the
// categorised kernels of grouped_likelihood.cu and categorised_likelihood.cu
// take its pieces): staging of h and the head weights in shared memory, the
// head products, and the two backward passes,
// templated on a likelihood family the way _make_fused_from in
// scvae_tpu/ops/fused_likelihood.py takes an (ll, grads) pair.
//
// A family is a struct with
//   static constexpr int kHeads;                      // dense heads, <= 3
//   static float ll(const float* a, float t);          // forward (count families)
//   static void grads(const float* a, float t, const float* extra, float* g);
// where a holds the kHeads activations a_k = h W_k + b_k of one (row, gene),
// g receives d ll / d a_k (zero outside each clip range) and extra the row's
// two RowExtras values (the constrained Poisson's lse and sum of t).
//
// Shared memory is bounded independently of the decoder width H: h and the
// weights are staged kChunk hidden units at a time and the activations
// accumulate over the chunks in order (for H <= kChunk that is one chunk, and
// the sums are those of an unchunked loop).  The dh pass gives each block one
// kChunk-wide column chunk of dh, one column per thread held in registers; the
// dW pass gives each block one kChunk-wide row chunk of dW, held in registers.
// A block whose output chunk is not the last staged one stages it again.  So
// for H > kChunk the backward recomputes the activations once per chunk.
// Every sum runs in a fixed order; nothing uses atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "special.cuh"

namespace scvae {
namespace {

constexpr float kTiny = 0x1p-126f;      // np.finfo(np.float32).tiny
constexpr float kPHi = 0x1.fffffep-1f;  // nextafter(1, 0)
constexpr float kLLo = -0x1.3ffffep+3f;  // nextafter(-10, +inf)
constexpr float kLHi = 0x1.3ffffep+3f;  // nextafter(10, -inf)

constexpr int kThreads = 256;
// Row-tile kernels (forward, dh): 16 rows per block, genes in tiles of 32.
constexpr int kRowTile = 16;
constexpr int kGeneTile = 32;
// dW kernel: 16 genes per block, rows in tiles of 32.
constexpr int kDwGeneTile = 16;
constexpr int kDwRowTile = 32;
// Hidden units staged at a time, and the width of a block's dh / dW chunk.
constexpr int kChunk = 256;
static_assert(kChunk == kThreads, "the dh pass gives each thread one column");
constexpr int kMaxHeads = 3;

struct Heads {
  const float* w[kMaxHeads];  // (H, F) each
  const float* b[kMaxHeads];  // (F,) each
};

struct HeadGrads {
  float* dw[kMaxHeads];  // (H, F) each
  float* db[kMaxHeads];  // (F,) each
};

// Per-row inputs of the constrained Poisson's gradient; null for the count
// families.
struct RowExtras {
  const float* lse;  // (M,) logsumexp of the row's activations
  const float* sx;   // (M_t,) sum of the targets of each target row
};

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int chunk_width(int hidden) {
  return hidden < kChunk ? hidden : kChunk;
}
__host__ __device__ inline int n_chunks(int hidden) {
  return (hidden + kChunk - 1) / kChunk;
}

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

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void load_extras(RowExtras extras, int row, int m_t,
                                            float extra[2]) {
  extra[0] = extras.lse ? extras.lse[row] : 0.0f;
  extra[1] = extras.sx ? extras.sx[row % m_t] : 0.0f;
}

// Rows [row0, row0 + rows) and hidden units [c0, c0 + cw) of h into sH (row
// stride hs, zero beyond), rounded to bf16 when asked.
__device__ __forceinline__ void stage_h(float* sH, const float* __restrict__ h,
                                        int row0, int rows, int m, int hidden,
                                        int c0, int cw, int hs,
                                        bool round_bf16) {
  for (int i = threadIdx.x; i < rows * hs; i += kThreads) {
    const int r = i / hs, c = i - r * hs;
    const int row = row0 + r;
    float v = (row < m && c < cw) ? h[(long long)row * hidden + c0 + c] : 0.0f;
    sH[i] = round_bf16 ? to_bf16(v) : v;
  }
}

// Hidden units [c0, c0 + cw) and genes [gene0, gene0 + GENES) of every
// head's weights into sW[k][hh][gg] (row stride ws, head stride cw * ws),
// zero beyond F.  Each thread keeps one gene column; the head index is a
// compile-time constant, so the weight pointers stay in the parameter space.
// HS is Heads or any type whose w[k] gives head k's (H, F) weights.
template <int NH, int GENES, class HS>
__device__ __forceinline__ void stage_w(float* sW, const HS& heads,
                                        int gene0, int ws, int c0, int cw,
                                        int f, bool round_bf16) {
  static_assert(kThreads % GENES == 0, "a thread keeps one gene column");
  const int gg = threadIdx.x % GENES;
  const int gene = gene0 + gg;
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const float* w = heads.w[k] + gene;
    for (int hh = threadIdx.x / GENES; hh < cw; hh += kThreads / GENES) {
      const float v = gene < f ? w[(long long)(c0 + hh) * f] : 0.0f;
      sW[(k * cw + hh) * ws + gg] = round_bf16 ? to_bf16(v) : v;
    }
  }
}

// acc[row][k] += sum over the cw staged hidden units of h[row] W_k[:, gc],
// for two rows (sH rows r0, r1), in order of the hidden unit.
template <int NH>
__device__ __forceinline__ void head_products(const float* sH, const float* sW,
                                              int r0, int r1, int gc, int hs,
                                              int ws, int cw,
                                              float acc[2][NH]) {
  const float* h0 = sH + r0 * hs;
  const float* h1 = sH + r1 * hs;
  const float* wk[NH];
#pragma unroll
  for (int k = 0; k < NH; ++k) wk[k] = sW + k * cw * ws + gc;
  int hh = 0;
  for (; hh + 4 <= cw; hh += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(h0 + hh);
    const float4 x1 = *reinterpret_cast<const float4*>(h1 + hh);
    const float xs0[4] = {x0.x, x0.y, x0.z, x0.w};
    const float xs1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        const float v = wk[k][(hh + q) * ws];
        acc[0][k] = fmaf(xs0[q], v, acc[0][k]);
        acc[1][k] = fmaf(xs1[q], v, acc[1][k]);
      }
    }
  }
  for (; hh < cw; ++hh) {
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      const float v = wk[k][hh * ws];
      acc[0][k] = fmaf(h0[hh], v, acc[0][k]);
      acc[1][k] = fmaf(h1[hh], v, acc[1][k]);
    }
  }
}

// acc_h[r] += sum_gg sum_k da_k[gg][r] W_k[col][gg] for the thread's dh
// column col = threadIdx.x of the staged chunk (cwy wide), with da_k in
// sDa[k][gg][r] and the chunk's weights in sW[k][col][gg] (row stride ws).
template <int NH>
__device__ __forceinline__ void dh_products(const float* sDa, const float* sW,
                                            int cwy, int ws,
                                            float (&acc_h)[kRowTile]) {
  const int tid = threadIdx.x;
  if (tid >= cwy) return;
  for (int gg = 0; gg < kGeneTile; ++gg) {
    float w[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) w[k] = sW[(k * cwy + tid) * ws + gg];
#pragma unroll
    for (int q = 0; q < kRowTile / 4; ++q) {
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        const float4 d = reinterpret_cast<const float4*>(
            sDa + (k * kGeneTile + gg) * kRowTile)[q];
        acc_h[4 * q + 0] = fmaf(d.x, w[k], acc_h[4 * q + 0]);
        acc_h[4 * q + 1] = fmaf(d.y, w[k], acc_h[4 * q + 1]);
        acc_h[4 * q + 2] = fmaf(d.z, w[k], acc_h[4 * q + 2]);
        acc_h[4 * q + 3] = fmaf(d.w, w[k], acc_h[4 * q + 3]);
      }
    }
  }
}

// da_k of one (row, gene) into sDa[k][gl][r], rounded to bf16 when asked.
template <int NH>
__device__ __forceinline__ void store_da(float* sDa, int gl, int r,
                                         const float (&da)[NH],
                                         bool round_bf16) {
#pragma unroll
  for (int k = 0; k < NH; ++k)
    sDa[(k * kGeneTile + gl) * kRowTile + r] =
        round_bf16 ? to_bf16(da[k]) : da[k];
}

// The dh products of one gene tile's staged da (sDa) with the block's dh
// chunk [cy * kChunk, cy * kChunk + cwy) of the heads' weights, which are
// staged again first when the last staged hidden chunk is another one.
template <int NH, class HS>
__device__ __forceinline__ void dh_tile(const float* sDa, float* sW,
                                        const HS& heads, int f0, int ws,
                                        int cy, int cwy, int f, bool restage,
                                        bool round_bf16,
                                        float (&acc_h)[kRowTile]) {
  if (restage) {
    __syncthreads();  // the last chunk's head products are done
    stage_w<NH, kGeneTile>(sW, heads, f0, ws, cy * kChunk, cwy, f, round_bf16);
  }
  __syncthreads();
  dh_products<NH>(sDa, sW, cwy, ws, acc_h);
}

// Row sums of a row tile: the 32 lanes of a warp hold partial sums of the
// same two rows rl[0], rl[1].
__device__ __forceinline__ void write_row_sums(float (&row_ll)[2],
                                               const int (&rl)[2], int row0,
                                               int gl, int m,
                                               float* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      row_ll[i] += __shfl_xor_sync(0xffffffffu, row_ll[i], off);
    const int row = row0 + rl[i];
    if (gl == 0 && row < m) out[row] = row_ll[i];
  }
}

// The block's dh chunk, column cy * kChunk + threadIdx.x of each row.
__device__ __forceinline__ void write_dh(const float (&acc_h)[kRowTile],
                                         int row0, int cy, int cwy, int m,
                                         int hidden, float* __restrict__ dh) {
  const int tid = threadIdx.x;
  if (tid >= cwy) return;
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    const int row = row0 + r;
    if (row < m) dh[(long long)row * hidden + cy * kChunk + tid] = acc_h[r];
  }
}

// Activations of rows r0, r1 of the block's tile at gene column gc of the
// gene tile starting at gene0, summed over every hidden chunk in order.
// sH holds the whole (single-chunk) h tile already when n_chunks(hidden) == 1.
template <int NH, int GENES, class HS>
__device__ __forceinline__ void tile_activations(
    float* sH, float* sW, const float* __restrict__ h, const HS& heads,
    int row0, int rows, int r0, int r1, int gene0, int gc, int ws, int m,
    int hidden, int f, int hs, bool stage_weights_once, bool round_bf16,
    float acc[2][NH]) {
  const int nc = n_chunks(hidden);
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * kChunk, cw = min(kChunk, hidden - c0);
    __syncthreads();  // readers of the previous sH / sW contents are done
    if (nc > 1) {
      stage_h(sH, h, row0, rows, m, hidden, c0, cw, hs, round_bf16);
      stage_w<NH, GENES>(sW, heads, gene0, ws, c0, cw, f, round_bf16);
    } else if (!stage_weights_once) {
      stage_w<NH, GENES>(sW, heads, gene0, ws, c0, cw, f, round_bf16);
    }
    __syncthreads();
    head_products<NH>(sH, sW, r0, r1, gc, hs, ws, cw, acc);
  }
}

// One block per tile of kRowTile rows (and, for the dh pass, one kChunk-wide
// column chunk of dh, blockIdx.y), looping over all genes in tiles of
// kGeneTile.  Thread layout: gene column tid % 32, rows tid / 32 and that + 8,
// so one warp owns two whole rows of the tile.
//   DH = false (K2): out[row] = sum_f ll (minus lgamma(1 + t) if asked).
//   DH = true (K3 / K7, pass 1): dh = sum_k bf16(g * dll/da_k) W_k^T.
template <class Fam, typename TT, bool DH>
__global__ void __launch_bounds__(kThreads)
    row_tile_kernel(const float* __restrict__ g, const float* __restrict__ h,
                    Heads heads, RowExtras extras, const TT* __restrict__ t,
                    float* __restrict__ out, int m, int m_t, int hidden, int f,
                    int round_bf16, int subtract_const) {
  constexpr int NH = Fam::kHeads;
  extern __shared__ __align__(16) float smem[];
  const int kc = chunk_width(hidden), nc = n_chunks(hidden);
  const int hs = round_up4(kc) + 4;
  const int ws = kGeneTile + 1;
  float* sH = smem;                               // [16][hs]
  float* sW = sH + kRowTile * hs;                 // [NH][kc][33]
  float* sDa = sW + round_up4(NH * kc * ws);      // [NH][32][16]

  const int row0 = blockIdx.x * kRowTile;
  const int gl = threadIdx.x % kGeneTile;
  const int ty = threadIdx.x / kGeneTile;
  const int rl[2] = {ty, ty + kRowTile / 2};
  // dh pass: the block's columns are [cy * kChunk, cy * kChunk + cwy), and
  // thread tid owns column cy * kChunk + tid.
  const int cy = DH ? blockIdx.y : 0;
  const int cwy = min(kChunk, hidden - cy * kChunk);

  float grow[2] = {0.0f, 0.0f};
  float extra[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (DH) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + rl[i];
      if (row < m) {
        grow[i] = g[row];
        load_extras(extras, row, m_t, extra[i]);
      }
    }
  }
  float row_ll[2] = {0.0f, 0.0f};
  float acc_h[kRowTile];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) acc_h[r] = 0.0f;

  if (nc == 1) stage_h(sH, h, row0, kRowTile, m, hidden, 0, kc, hs, round_bf16);
  for (int f0 = 0; f0 < f; f0 += kGeneTile) {
    float acc[2][NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) acc[0][k] = acc[1][k] = 0.0f;
    tile_activations<NH, kGeneTile>(sH, sW, h, heads, row0, kRowTile, rl[0],
                                    rl[1], f0, gl, ws, m, hidden, f, hs, false,
                                    round_bf16, acc);
    const int gene = f0 + gl;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + rl[i];
      const bool valid = row < m && gene < f;
      float a[NH];
      if (valid) {
#pragma unroll
        for (int k = 0; k < NH; ++k) a[k] = acc[i][k] + heads.b[k][gene];
      }
      if constexpr (!DH) {
        if (valid) {
          const float tv = load_f(t + (long long)(row % m_t) * f + gene);
          float ll = Fam::ll(a, tv);
          if (subtract_const) ll -= series_lgamma(1.0f + tv);
          row_ll[i] += ll;
        }
      } else {
        float da[NH];
#pragma unroll
        for (int k = 0; k < NH; ++k) da[k] = 0.0f;
        if (valid) {
          const float tv = load_f(t + (long long)(row % m_t) * f + gene);
          Fam::grads(a, tv, extra[i], da);
#pragma unroll
          for (int k = 0; k < NH; ++k) da[k] *= grow[i];
        }
        store_da<NH>(sDa, gl, rl[i], da, round_bf16);
      }
    }
    if constexpr (DH)
      dh_tile<NH>(sDa, sW, heads, f0, ws, cy, cwy, f, nc > 1 && cy != nc - 1,
                  round_bf16, acc_h);
  }

  if constexpr (!DH)
    write_row_sums(row_ll, rl, row0, gl, m, out);
  else
    write_dh(acc_h, row0, cy, cwy, m, hidden, out);
}

// Backward pass 2 over the NH heads of a head source HS (whose w[k], b[k]
// give head k's weights and bias; Out's dw[k], db[k] its gradients): one
// block per tile of kDwGeneTile genes (blockIdx.x) and one kChunk-wide row
// chunk of dW (blockIdx.y), looping over all rows in tiles of kDwRowTile.
// dW_k[chunk, genes] = h^T bf16(da_k) in registers and db_k[genes] =
// sum_rows da_k (unrounded; written by the chunk-0 blocks), in a fixed
// order, for the first n heads.  da_k = g dll/da_k, where
// grads(row, gene, t, a, da) writes dll/da_k into da (zero on entry).
// Thread layout: gene tid % 16; rows tid / 16 and that + 16 for the
// activations; hidden units tid / 16 + 16 j of the chunk for dW.
template <int NH, typename TT, class HS, class Out, class Grads>
__device__ __forceinline__ void dw_body(const float* __restrict__ g,
                                        const float* __restrict__ h,
                                        const HS& heads,
                                        const TT* __restrict__ t,
                                        const Out& out, int n, int m, int m_t,
                                        int hidden, int f, int round_bf16,
                                        const Grads& grads) {
  constexpr int TG = kDwGeneTile, TR = kDwRowTile;
  constexpr int kJ = kChunk / TG;  // hidden units of the chunk per thread
  extern __shared__ __align__(16) float smem[];
  const int kc = chunk_width(hidden), nc = n_chunks(hidden);
  const int hs = round_up4(kc) + 4;
  float* sH = smem;                              // [32][hs]
  float* sW = sH + TR * hs;                      // [NH][kc][16]
  float* sDa = sW + round_up4(NH * kc * TG);     // [NH][32][16]
  float* sDb = sDa + NH * TR * TG;               // [NH][16][16]

  const int tid = threadIdx.x;
  const int gene0 = blockIdx.x * TG;
  const int gl = tid % TG;
  const int ry = tid / TG;  // 0..15
  const int gene = gene0 + gl;
  const int cy = blockIdx.y;
  const int cwy = min(kChunk, hidden - cy * kChunk);

  float bias[NH];
#pragma unroll
  for (int k = 0; k < NH; ++k) bias[k] = gene < f ? heads.b[k][gene] : 0.0f;
  float acc_w[kJ][NH];
  float db_acc[NH];
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    db_acc[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc_w[j][k] = 0.0f;
  }

  if (nc == 1) stage_w<NH, TG>(sW, heads, gene0, TG, 0, kc, f, round_bf16);
  for (int row0 = 0; row0 < m; row0 += TR) {
    float acc[2][NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) acc[0][k] = acc[1][k] = 0.0f;
    if (nc == 1) {
      __syncthreads();  // the previous row tile's readers of sH / sDa are done
      stage_h(sH, h, row0, TR, m, hidden, 0, kc, hs, round_bf16);
    }
    tile_activations<NH, TG>(sH, sW, h, heads, row0, TR, ry, ry + TR / 2,
                             gene0, gl, TG, m, hidden, f, hs, true, round_bf16,
                             acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rloc = ry + i * (TR / 2);
      const int row = row0 + rloc;
      float da[NH];
#pragma unroll
      for (int k = 0; k < NH; ++k) da[k] = 0.0f;
      if (row < m && gene < f) {
        const float tv = load_f(t + (long long)(row % m_t) * f + gene);
        float a[NH];
#pragma unroll
        for (int k = 0; k < NH; ++k) a[k] = acc[i][k] + bias[k];
        grads(row, gene, tv, a, da);
        const float gv = g[row];
#pragma unroll
        for (int k = 0; k < NH; ++k) da[k] *= gv;
      }
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        db_acc[k] += da[k];
        sDa[(k * TR + rloc) * TG + gl] = round_bf16 ? to_bf16(da[k]) : da[k];
      }
    }
    if (nc > 1 && cy != nc - 1) {
      __syncthreads();  // the last chunk's head products are done
      stage_h(sH, h, row0, TR, m, hidden, cy * kChunk, cwy, hs, round_bf16);
    }
    __syncthreads();
    // dW_k[hh][gl] += sum_r h[r][hh] da_k[r][gl]
    for (int r = 0; r < TR; ++r) {
      float d[NH];
#pragma unroll
      for (int k = 0; k < NH; ++k) d[k] = sDa[(k * TR + r) * TG + gl];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int hh = ry + TG * j;
        const float hv = hh < cwy ? sH[r * hs + hh] : 0.0f;
#pragma unroll
        for (int k = 0; k < NH; ++k) acc_w[j][k] = fmaf(hv, d[k], acc_w[j][k]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int hh = ry + TG * j;
    if (hh < cwy && gene < f) {
#pragma unroll
      for (int k = 0; k < NH; ++k)
        if (k < n) out.dw[k][(long long)(cy * kChunk + hh) * f + gene] =
            acc_w[j][k];
    }
  }
  if (cy != 0) return;
#pragma unroll
  for (int k = 0; k < NH; ++k) sDb[(k * TG + ry) * TG + gl] = db_acc[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    if (tid / TG == k && k < n) {
      const int gg = tid - k * TG;
      float s = 0.0f;
      for (int j = 0; j < TG; ++j) s += sDb[(k * TG + j) * TG + gg];
      if (gene0 + gg < f) out.db[k][gene0 + gg] = s;
    }
  }
}

// A count family's dll/da at one (row, gene), with the row's extras.
template <class Fam>
struct FamilyGrads {
  RowExtras extras;
  int m_t;
  __device__ __forceinline__ void operator()(int row, int, float t,
                                             const float* a, float* da) const {
    float extra[2];
    load_extras(extras, row, m_t, extra);
    Fam::grads(a, t, extra, da);
  }
};

template <class Fam, typename TT>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const float* __restrict__ g, const float* __restrict__ h,
              Heads heads, RowExtras extras, const TT* __restrict__ t,
              HeadGrads out, int m, int m_t, int hidden, int f,
              int round_bf16) {
  dw_body<Fam::kHeads>(g, h, heads, t, out, Fam::kHeads, m, m_t, hidden, f,
                       round_bf16, FamilyGrads<Fam>{extras, m_t});
}

// Dynamic shared memory of each kernel, bounded for any H: at most
// (16 * 260 + 3 * 256 * 33 + 3 * 512) floats = 124,160 bytes (row tile, three
// heads) and 91,648 bytes (dW pass).
template <int NH>
size_t row_tile_smem(int hidden) {
  const int kc = chunk_width(hidden);
  const size_t floats = (size_t)kRowTile * (round_up4(kc) + 4) +
                        round_up4(NH * kc * (kGeneTile + 1)) +
                        NH * kGeneTile * kRowTile;
  return floats * sizeof(float);
}

template <int NH>
size_t dw_smem(int hidden) {
  const int kc = chunk_width(hidden);
  const size_t floats = (size_t)kDwRowTile * (round_up4(kc) + 4) +
                        round_up4(NH * kc * kDwGeneTile) +
                        NH * kDwRowTile * kDwGeneTile +
                        NH * kDwGeneTile * kDwGeneTile;
  return floats * sizeof(float);
}

// Allow `bytes` of dynamic shared memory; a refusal is returned and cleared
// from CUDA's last-error state, so it does not surface in a later launch.
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

template <class Fam, typename TT, bool DH>
int launch_row_tile(const float* g, const float* h, Heads heads,
                    RowExtras extras, const void* t, float* out, int m,
                    int m_t, int hidden, int f, int round_bf16,
                    int subtract_const, cudaStream_t stream) {
  const size_t bytes = row_tile_smem<Fam::kHeads>(hidden);
  auto kernel = row_tile_kernel<Fam, TT, DH>;
  if (int err = set_smem(kernel, bytes)) return err;
  const dim3 grid((m + kRowTile - 1) / kRowTile, DH ? n_chunks(hidden) : 1);
  kernel<<<grid, kThreads, bytes, stream>>>(
      g, h, heads, extras, static_cast<const TT*>(t), out, m, m_t, hidden, f,
      round_bf16, subtract_const);
  return (int)cudaGetLastError();
}

template <class Fam, typename TT>
int launch_dw(const float* g, const float* h, Heads heads, RowExtras extras,
              const void* t, HeadGrads out, int m, int m_t, int hidden, int f,
              int round_bf16, cudaStream_t stream) {
  const size_t bytes = dw_smem<Fam::kHeads>(hidden);
  auto kernel = dw_kernel<Fam, TT>;
  if (int err = set_smem(kernel, bytes)) return err;
  const dim3 grid((f + kDwGeneTile - 1) / kDwGeneTile, n_chunks(hidden));
  kernel<<<grid, kThreads, bytes, stream>>>(
      g, h, heads, extras, static_cast<const TT*>(t), out, m, m_t, hidden, f,
      round_bf16);
  return (int)cudaGetLastError();
}

// Calls fn(T{}) with T = float for t_dtype 0 and __nv_bfloat16 for 1.
template <typename Fn>
int with_t_type(int t_dtype, Fn&& fn) {
  if (t_dtype == 0) return fn(float{});
  if (t_dtype == 1) return fn(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace scvae
