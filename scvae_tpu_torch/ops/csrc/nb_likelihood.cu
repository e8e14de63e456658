// K2 / K3: fused negative-binomial decoder heads + log-likelihood, forward
// and backward.
//
// Replaces the Pallas kernels of scvae_tpu/ops/fused_likelihood.py for the
// negative-binomial instance: _make_forward_kernel with _nb_ll, driven by
// _fused_forward (K2), and _make_backward_kernel with _nb_grads, driven by
// _fused_backward (K3).  For M rows of decoder output h (M, H) and the two
// heads k in {p, log_r} with weights W_k (H, F) and biases b_k (F,):
//
//   a_k = h W_k + b_k                                    (bf16-rounded inputs
//                                                         when asked, f32 sums)
//   ll  = sum_f NB(t | p = clip(sigmoid(a_p)), r = exp(clip(a_r)))
//   da_k = g * dll/da_k        (zero outside each clip range)
//   dh   = sum_k bf16(da_k) W_k^T,  dW_k = h^T bf16(da_k),  db_k = sum_rows da_k
//
// The (M, F) activations never reach device memory: every kernel recomputes
// them tile by tile, as the TPU kernels do.  The TPU backward accumulates dh
// and dW by revisiting output blocks across a sequential grid; CUDA blocks run
// in no order, so the backward is two passes here, each deterministic and
// without atomics:
//   nb_row_tile_kernel<.., true>   one block per row tile, loops over genes -> dh
//   nb_backward_dw_kernel          one block per gene tile, loops over rows -> dW, db
// The forward is nb_row_tile_kernel<.., false>: one block per row tile, the
// row sums kept in registers and reduced across the warp in a fixed order.
//
// Bound on the H100 at the headline shape (M = F = 2048, H = 256): the head
// products, 2 * 2 * M * H * F = 4.3 GFLOP per pass (8.6 GFLOP for each
// backward pass, which recomputes the activations), against ~15 MB of
// inputs.  This first version runs the products as float FMAs on the CUDA
// cores from shared-memory tiles (no tensor cores, TMA or wgmma), one block
// of 8 warps per SM at the headline shape, far above the tensor-core bound.
//
// Transcendentals use the shift-3 series of special.cuh and the clip
// constants of the reference (_TINY, _P_HI, _L_LO, _L_HI).  Clips propagate
// NaN like jnp.clip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "special.cuh"

namespace {

using scvae::series_digamma;
using scvae::series_lgamma;

constexpr float kTiny = 0x1p-126f;          // np.finfo(np.float32).tiny
constexpr float kPHi = 0x1.fffffep-1f;      // nextafter(1, 0)
constexpr float kLLo = -0x1.3ffffep+3f;     // nextafter(-10, +inf)
constexpr float kLHi = 0x1.3ffffep+3f;      // nextafter(10, -inf)

constexpr int kThreads = 256;
// Row-tile kernels (forward, dh): 16 rows per block, genes in tiles of 32.
constexpr int kRowTile = 16;
constexpr int kGeneTile = 32;
// dW kernel: 16 genes per block, rows in tiles of 32.
constexpr int kDwGeneTile = 16;
constexpr int kDwRowTile = 32;

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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

// _nb_ll: log NB(t | p, r) without the -lgamma(1 + t) constant.
__device__ __forceinline__ float nb_ll(float a_p, float a_r, float t) {
  const float p = clip(sigmoid(a_p), kTiny, kPHi);
  const float r = expf(clip(a_r, kLLo, kLHi));
  return series_lgamma(t + r) - series_lgamma(r) + r * log1pf(-p) +
         t * logf(p);
}

// _nb_grads: d ll / d a_p and d ll / d a_r.
__device__ __forceinline__ void nb_grads(float a_p, float a_r, float t,
                                         float* g_p, float* g_r) {
  const float p_raw = sigmoid(a_p);
  const float p = clip(p_raw, kTiny, kPHi);
  const float r = expf(clip(a_r, kLLo, kLHi));
  const bool p_inside = p_raw > kTiny && p_raw < kPHi;
  *g_p = p_inside ? t * (1.0f - p) - r * p : 0.0f;
  const bool r_inside = a_r > kLLo && a_r < kLHi;
  *g_r = r_inside
             ? r * (series_digamma(t + r) - series_digamma(r) + log1pf(-p))
             : 0.0f;
}

struct Heads {
  const float* wp;  // (H, F)
  const float* bp;  // (F,)
  const float* wr;  // (H, F)
  const float* br;  // (F,)
};

// Rows [row0, row0 + rows) of h into sH (row stride hs, zero padded),
// rounded to bf16 when asked.
__device__ __forceinline__ void stage_h(float* sH, const float* __restrict__ h,
                                        int row0, int rows, int m, int hidden,
                                        int hs, bool round_bf16) {
  for (int i = threadIdx.x; i < rows * hs; i += kThreads) {
    const int r = i / hs, c = i - r * hs;
    const int row = row0 + r;
    float v = (row < m && c < hidden) ? h[(long long)row * hidden + c] : 0.0f;
    sH[i] = round_bf16 ? to_bf16(v) : v;
  }
}

// Columns [gene0, gene0 + genes) of both head weights into
// sW[k][hh][0..genes) with row stride ws, zero beyond F.
__device__ __forceinline__ void stage_w(float* sW, Heads heads, int gene0,
                                        int genes, int ws, int hidden, int f,
                                        bool round_bf16) {
  const int per_head = hidden * genes;
  for (int i = threadIdx.x; i < 2 * per_head; i += kThreads) {
    const int k = i / per_head;
    const int rem = i - k * per_head;
    const int hh = rem / genes, gg = rem - hh * genes;
    const int gene = gene0 + gg;
    const float* w = k ? heads.wr : heads.wp;
    float v = gene < f ? w[(long long)hh * f + gene] : 0.0f;
    sW[(k * hidden + hh) * ws + gg] = round_bf16 ? to_bf16(v) : v;
  }
}

// Activations of two rows (sH rows r0, r1) at one gene column (gc) of the
// staged weights: acc[row][head], summed over hh in order.
__device__ __forceinline__ void head_products(const float* sH, const float* sW,
                                              int r0, int r1, int gc, int hs,
                                              int ws, int hidden,
                                              float acc[2][2]) {
  const float* h0 = sH + r0 * hs;
  const float* h1 = sH + r1 * hs;
  const float* wp = sW + gc;
  const float* wr = sW + hidden * ws + gc;
  int hh = 0;
  for (; hh + 4 <= hidden; hh += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(h0 + hh);
    const float4 x1 = *reinterpret_cast<const float4*>(h1 + hh);
    const float xs0[4] = {x0.x, x0.y, x0.z, x0.w};
    const float xs1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float vp = wp[(hh + q) * ws];
      const float vr = wr[(hh + q) * ws];
      acc[0][0] = fmaf(xs0[q], vp, acc[0][0]);
      acc[0][1] = fmaf(xs0[q], vr, acc[0][1]);
      acc[1][0] = fmaf(xs1[q], vp, acc[1][0]);
      acc[1][1] = fmaf(xs1[q], vr, acc[1][1]);
    }
  }
  for (; hh < hidden; ++hh) {
    const float vp = wp[hh * ws];
    const float vr = wr[hh * ws];
    acc[0][0] = fmaf(h0[hh], vp, acc[0][0]);
    acc[0][1] = fmaf(h0[hh], vr, acc[0][1]);
    acc[1][0] = fmaf(h1[hh], vp, acc[1][0]);
    acc[1][1] = fmaf(h1[hh], vr, acc[1][1]);
  }
}

// One block per tile of kRowTile rows, looping over all genes in tiles of
// kGeneTile.  Thread layout: gene column tid % 32, rows tid / 32 and that + 8,
// so one warp owns two whole rows of the tile.
//   DH = false (K2): out[row] = sum_f ll (minus lgamma(1 + t) if asked).
//   DH = true (K3, pass 1): dh = sum_k bf16(g * dll/da_k) W_k^T.
template <typename TT, bool DH>
__global__ void __launch_bounds__(kThreads)
    nb_row_tile_kernel(const float* __restrict__ g, const float* __restrict__ h,
                       Heads heads, const TT* __restrict__ t,
                       float* __restrict__ out, int m, int m_t, int hidden,
                       int f, int round_bf16, int subtract_const) {
  extern __shared__ __align__(16) float smem[];
  const int hs = round_up4(hidden) + 4;
  const int ws = kGeneTile + 1;
  float* sH = smem;                                           // [16][hs]
  float* sW = sH + kRowTile * hs;                             // [2][H][33]
  float* sDa = sW + round_up4(2 * hidden * ws);               // [2][32][16]
  float* sDh = sDa + 2 * kGeneTile * kRowTile;                // [16][H]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowTile;
  const int gl = tid % kGeneTile;
  const int ty = tid / kGeneTile;
  const int rl[2] = {ty, ty + kRowTile / 2};

  stage_h(sH, h, row0, kRowTile, m, hidden, hs, round_bf16);
  float grow[2] = {0.0f, 0.0f};
  if (DH) {
    for (int i = tid; i < kRowTile * hidden; i += kThreads) sDh[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + rl[i] < m) grow[i] = g[row0 + rl[i]];
  }
  float row_ll[2] = {0.0f, 0.0f};

  for (int f0 = 0; f0 < f; f0 += kGeneTile) {
    __syncthreads();  // the previous tile's readers of sW / sDa are done
    stage_w(sW, heads, f0, kGeneTile, ws, hidden, f, round_bf16);
    __syncthreads();
    float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    head_products(sH, sW, rl[0], rl[1], gl, hs, ws, hidden, acc);
    const int gene = f0 + gl;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + rl[i];
      const bool valid = row < m && gene < f;
      if (!DH) {
        if (valid) {
          const float a_p = acc[i][0] + heads.bp[gene];
          const float a_r = acc[i][1] + heads.br[gene];
          const float tv = load_f(t + (long long)(row % m_t) * f + gene);
          float ll = nb_ll(a_p, a_r, tv);
          if (subtract_const) ll -= series_lgamma(1.0f + tv);
          row_ll[i] += ll;
        }
      } else {
        float gp = 0.0f, gr = 0.0f;
        if (valid) {
          const float a_p = acc[i][0] + heads.bp[gene];
          const float a_r = acc[i][1] + heads.br[gene];
          const float tv = load_f(t + (long long)(row % m_t) * f + gene);
          nb_grads(a_p, a_r, tv, &gp, &gr);
          gp *= grow[i];
          gr *= grow[i];
        }
        sDa[(0 * kGeneTile + gl) * kRowTile + rl[i]] = round_bf16 ? to_bf16(gp) : gp;
        sDa[(1 * kGeneTile + gl) * kRowTile + rl[i]] = round_bf16 ? to_bf16(gr) : gr;
      }
    }
    if (DH) {
      __syncthreads();
      // dh[r][hh] += sum_gg da_p[gg][r] Wp[hh][gg] + da_r[gg][r] Wr[hh][gg]
      for (int hh = tid; hh < hidden; hh += kThreads) {
        float acc_h[kRowTile];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) acc_h[r] = sDh[r * hidden + hh];
        for (int gg = 0; gg < kGeneTile; ++gg) {
          const float vp = sW[hh * ws + gg];
          const float vr = sW[(hidden + hh) * ws + gg];
          const float4* dp =
              reinterpret_cast<const float4*>(sDa + (0 * kGeneTile + gg) * kRowTile);
          const float4* dr =
              reinterpret_cast<const float4*>(sDa + (1 * kGeneTile + gg) * kRowTile);
#pragma unroll
          for (int q = 0; q < kRowTile / 4; ++q) {
            const float4 a = dp[q];
            const float4 b = dr[q];
            acc_h[4 * q + 0] = fmaf(b.x, vr, fmaf(a.x, vp, acc_h[4 * q + 0]));
            acc_h[4 * q + 1] = fmaf(b.y, vr, fmaf(a.y, vp, acc_h[4 * q + 1]));
            acc_h[4 * q + 2] = fmaf(b.z, vr, fmaf(a.z, vp, acc_h[4 * q + 2]));
            acc_h[4 * q + 3] = fmaf(b.w, vr, fmaf(a.w, vp, acc_h[4 * q + 3]));
          }
        }
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) sDh[r * hidden + hh] = acc_h[r];
      }
    }
  }

  if (!DH) {
    // The 32 lanes of a warp hold partial sums of the same two rows.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        row_ll[i] += __shfl_xor_sync(0xffffffffu, row_ll[i], off);
      const int row = row0 + rl[i];
      if (gl == 0 && row < m) out[row] = row_ll[i];
    }
  } else {
    __syncthreads();
    for (int i = tid; i < kRowTile * hidden; i += kThreads) {
      const int r = i / hidden, c = i - r * hidden;
      const int row = row0 + r;
      if (row < m) out[(long long)row * hidden + c] = sDh[i];
    }
  }
}

// K3, pass 2: one block per tile of kDwGeneTile genes, looping over all rows
// in tiles of kDwRowTile.  dW_k[:, genes] = h^T bf16(da_k) and
// db_k[genes] = sum_rows da_k (unrounded), accumulated in shared memory in
// a fixed order.  Thread layout for the activations: gene tid % 16, rows
// tid / 16 and that + 16; for dW: gene tid % 16, hidden units tid / 16 + 16 j.
template <typename TT>
__global__ void __launch_bounds__(kThreads)
    nb_backward_dw_kernel(const float* __restrict__ g,
                          const float* __restrict__ h, Heads heads,
                          const TT* __restrict__ t, float* __restrict__ dwp,
                          float* __restrict__ dbp, float* __restrict__ dwr,
                          float* __restrict__ dbr, int m, int m_t, int hidden,
                          int f, int round_bf16) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TG = kDwGeneTile, TR = kDwRowTile;
  const int hs = round_up4(hidden) + 4;
  float* sH = smem;                               // [32][hs]
  float* sW = sH + TR * hs;                       // [2][H][16]
  float* sDW = sW + round_up4(2 * hidden * TG);   // [2][H][16]
  float* sDa = sDW + round_up4(2 * hidden * TG);  // [2][32][16]
  float* sDb = sDa + 2 * TR * TG;                 // [2][16][16]

  const int tid = threadIdx.x;
  const int gene0 = blockIdx.x * TG;
  const int gl = tid % TG;
  const int ry = tid / TG;  // 0..15
  const int gene = gene0 + gl;

  stage_w(sW, heads, gene0, TG, TG, hidden, f, round_bf16);
  for (int i = tid; i < 2 * hidden * TG; i += kThreads) sDW[i] = 0.0f;
  const float bp = gene < f ? heads.bp[gene] : 0.0f;
  const float br = gene < f ? heads.br[gene] : 0.0f;
  float db_acc[2] = {0.0f, 0.0f};

  for (int row0 = 0; row0 < m; row0 += TR) {
    __syncthreads();  // the previous tile's readers of sH / sDa are done
    stage_h(sH, h, row0, TR, m, hidden, hs, round_bf16);
    __syncthreads();
    float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    head_products(sH, sW, ry, ry + TR / 2, gl, hs, TG, hidden, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rloc = ry + i * (TR / 2);
      const int row = row0 + rloc;
      float gp = 0.0f, gr = 0.0f;
      if (row < m && gene < f) {
        const float tv = load_f(t + (long long)(row % m_t) * f + gene);
        nb_grads(acc[i][0] + bp, acc[i][1] + br, tv, &gp, &gr);
        const float gv = g[row];
        gp *= gv;
        gr *= gv;
      }
      db_acc[0] += gp;
      db_acc[1] += gr;
      sDa[(0 * TR + rloc) * TG + gl] = round_bf16 ? to_bf16(gp) : gp;
      sDa[(1 * TR + rloc) * TG + gl] = round_bf16 ? to_bf16(gr) : gr;
    }
    __syncthreads();
    // dW_k[hh][gl] += sum_r h[r][hh] da_k[r][gl], eight hidden units at a time.
    for (int j0 = 0; ry + TG * j0 < hidden; j0 += 8) {
      float acc_w[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int hh = ry + TG * (j0 + j);
        acc_w[j][0] = hh < hidden ? sDW[hh * TG + gl] : 0.0f;
        acc_w[j][1] = hh < hidden ? sDW[(hidden + hh) * TG + gl] : 0.0f;
      }
      for (int r = 0; r < TR; ++r) {
        const float dp = sDa[(0 * TR + r) * TG + gl];
        const float dr = sDa[(1 * TR + r) * TG + gl];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int hh = ry + TG * (j0 + j);
          const float hv = hh < hidden ? sH[r * hs + hh] : 0.0f;
          acc_w[j][0] = fmaf(hv, dp, acc_w[j][0]);
          acc_w[j][1] = fmaf(hv, dr, acc_w[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int hh = ry + TG * (j0 + j);
        if (hh < hidden) {
          sDW[hh * TG + gl] = acc_w[j][0];
          sDW[(hidden + hh) * TG + gl] = acc_w[j][1];
        }
      }
    }
  }

  sDb[(0 * TG + ry) * TG + gl] = db_acc[0];
  sDb[(1 * TG + ry) * TG + gl] = db_acc[1];
  __syncthreads();
  for (int i = tid; i < 2 * hidden * TG; i += kThreads) {
    const int k = i / (hidden * TG);
    const int rem = i - k * hidden * TG;
    const int hh = rem / TG, gg = rem - hh * TG;
    if (gene0 + gg < f) (k ? dwr : dwp)[(long long)hh * f + gene0 + gg] = sDW[i];
  }
  if (tid < 2 * TG) {
    const int k = tid / TG, gg = tid - k * TG;
    float s = 0.0f;
    for (int j = 0; j < TG; ++j) s += sDb[(k * TG + j) * TG + gg];
    if (gene0 + gg < f) (k ? dbr : dbp)[gene0 + gg] = s;
  }
}

size_t row_tile_smem(int hidden, bool dh) {
  const int hs = round_up4(hidden) + 4;
  size_t floats = (size_t)kRowTile * hs + round_up4(2 * hidden * (kGeneTile + 1));
  if (dh) floats += 2 * kGeneTile * kRowTile + (size_t)kRowTile * hidden;
  return floats * sizeof(float);
}

size_t dw_smem(int hidden) {
  const int hs = round_up4(hidden) + 4;
  size_t floats = (size_t)kDwRowTile * hs + 2 * (size_t)round_up4(2 * hidden * kDwGeneTile) +
                  2 * kDwRowTile * kDwGeneTile + 2 * kDwGeneTile * kDwGeneTile;
  return floats * sizeof(float);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TT, bool DH>
int launch_row_tile(const float* g, const float* h, Heads heads, const void* t,
                    float* out, int m, int m_t, int hidden, int f,
                    int round_bf16, int subtract_const, cudaStream_t stream) {
  const size_t bytes = row_tile_smem(hidden, DH);
  auto kernel = nb_row_tile_kernel<TT, DH>;
  int err = set_smem(kernel, bytes);
  if (err) return err;
  const int blocks = (m + kRowTile - 1) / kRowTile;
  kernel<<<blocks, kThreads, bytes, stream>>>(
      g, h, heads, static_cast<const TT*>(t), out, m, m_t, hidden, f,
      round_bf16, subtract_const);
  return (int)cudaGetLastError();
}

template <typename TT>
int launch_dw(const float* g, const float* h, Heads heads, const void* t,
              float* dwp, float* dbp, float* dwr, float* dbr, int m, int m_t,
              int hidden, int f, int round_bf16, cudaStream_t stream) {
  const size_t bytes = dw_smem(hidden);
  auto kernel = nb_backward_dw_kernel<TT>;
  int err = set_smem(kernel, bytes);
  if (err) return err;
  const int blocks = (f + kDwGeneTile - 1) / kDwGeneTile;
  kernel<<<blocks, kThreads, bytes, stream>>>(
      g, h, heads, static_cast<const TT*>(t), dwp, dbp, dwr, dbr, m, m_t,
      hidden, f, round_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All return a cudaError_t (0 on success).  t_dtype: 0 = float32,
// 1 = bfloat16.  h rows cycle over the m_t rows of t (m % m_t == 0).

int scvae_nb_forward(const float* h, const float* wp, const float* bp,
                     const float* wr, const float* br, const void* t,
                     int t_dtype, float* out, int m, int m_t, int hidden,
                     int f, int round_bf16, int subtract_const, void* stream) {
  if (m == 0) return 0;
  Heads heads{wp, bp, wr, br};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_dtype == 0)
    return launch_row_tile<float, false>(nullptr, h, heads, t, out, m, m_t,
                                         hidden, f, round_bf16,
                                         subtract_const, s);
  if (t_dtype == 1)
    return launch_row_tile<__nv_bfloat16, false>(nullptr, h, heads, t, out, m,
                                                 m_t, hidden, f, round_bf16,
                                                 subtract_const, s);
  return (int)cudaErrorInvalidValue;
}

int scvae_nb_backward_dh(const float* g, const float* h, const float* wp,
                         const float* bp, const float* wr, const float* br,
                         const void* t, int t_dtype, float* dh, int m,
                         int m_t, int hidden, int f, int round_bf16,
                         void* stream) {
  if (m == 0) return 0;
  Heads heads{wp, bp, wr, br};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_dtype == 0)
    return launch_row_tile<float, true>(g, h, heads, t, dh, m, m_t, hidden, f,
                                        round_bf16, 0, s);
  if (t_dtype == 1)
    return launch_row_tile<__nv_bfloat16, true>(g, h, heads, t, dh, m, m_t,
                                                hidden, f, round_bf16, 0, s);
  return (int)cudaErrorInvalidValue;
}

int scvae_nb_backward_dw(const float* g, const float* h, const float* wp,
                         const float* bp, const float* wr, const float* br,
                         const void* t, int t_dtype, float* dwp, float* dbp,
                         float* dwr, float* dbr, int m, int m_t, int hidden,
                         int f, int round_bf16, void* stream) {
  if (f == 0) return 0;
  Heads heads{wp, bp, wr, br};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_dtype == 0)
    return launch_dw<float>(g, h, heads, t, dwp, dbp, dwr, dbr, m, m_t, hidden,
                            f, round_bf16, s);
  if (t_dtype == 1)
    return launch_dw<__nv_bfloat16>(g, h, heads, t, dwp, dbp, dwr, dbr, m, m_t,
                                    hidden, f, round_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
