// The categorised K3 with bf16 operands on the tensor cores: the backward's
// gradient kernel over a Poisson, NB, ZIP or ZINB base plus C = K + 1
// class-logit heads (up to 32 heads in all), for compute_dtype=bfloat16
// (the training path).  Its dh and dW are then two plain products of the
// scratch it writes (tc_product.cu).
//
// Replaces, for bf16 inputs, the Pallas kernel of
// scvae_tpu/ops/fused_likelihood.py that _fused_backward drives (K3) for
// the categorised instances _make_fused_categorised builds (the grads of
// _categorised_grads).  The float32 instances keep the CUDA-core kernels of
// categorised_likelihood.cu.  With the per-element lse (M, F) that the
// forward wrote:
//
//   a     = bf16(h) bf16(W) + b for every head   (float32 sums, b unrounded)
//   da_c  = g ([min(t, K) = c] - exp(a_c - lse))          class c
//   da_k  = g [t >= K] dbase_ll/da_k (t - K)               base head k
//
// Operands arrive in bf16 from the wrapper: h (M, Hp) and every head's
// weights side by side, W (Hp, NH, Fp) with the base heads first, zero-
// padded to Hp, Fp = multiples of 8.  One block per 64 rows x 64 genes walks
// the base heads, then the class heads four at a time: each group's products
// run through the ring of tc_common.cuh with W offset by the group's first
// head, and its epilogue writes bf16(da) into the scratch (M, NH * Fp),
// zero past F, and the unrounded column sums of the block's rows into a
// (row tiles, NH * Fp) partial array for db.  Since the forward's lse is
// given, each class's gradient needs only its own activation: no online
// softmax, and the groups are independent.
//
// Bound on the H100 at Poisson-cat's shape (32 heads, M = F = 2,048, H =
// 256): 68.7 GFLOP of head products (0.069 ms at 989 TFLOP/s) against h,
// W (33.5 MB), t and lse (16.8 MB) in and the bf16 da (268 MB) out (0.095 ms
// at 3.35 TB/s): bytes.  The design writes da once, coalesced (a warp per
// row, its lanes along the genes), and never rereads the activations.

#include "tc_common.cuh"

namespace scvae {
namespace {

// [min(t, K) = c] as _categorised_grads tests it: c <= t < c + 1 below K.
__device__ __forceinline__ float cat_indicator(float t, int c, int k) {
  const bool hit = c < k ? (t >= (float)c && t < (float)(c + 1))
                         : t >= (float)k;
  return hit ? 1.0f : 0.0f;
}

// Class heads per group: four (faster than two for ZINB-cat and no slower
// for Poisson-cat on the H100); a block's accumulators then fill its
// registers, so two blocks (eight warps) share an SM.
constexpr int kCatGroup = 4;

template <class Fam>
constexpr size_t cat_tc_smem() {
  return tc_heads_smem<Fam::kHeads>() > tc_heads_smem<kCatGroup>()
             ? tc_heads_smem<Fam::kHeads>()
             : tc_heads_smem<kCatGroup>();
}

// The operands shared by a block's head groups.
struct CatGrad {
  const bf16* h;
  const bf16* w;
  const float* bias;   // (NH, f)
  const void* t;
  int t_bf16;
  const float* lse;    // (m, f)
  const float* g;      // (m,)
  float* part;         // (row tiles, NH * fp)
  bf16* da;            // (m, NH * fp)
  int m, m_t, hp, f, fp, n_heads, k;
};

// Heads head0 ... head0 + n - 1 (NB slots; slots past n read zeros and are
// not written): the products, then da and its column sums.  BASE: the base
// family's heads (n = NB); otherwise the classes c = head0 - n_base + j.
template <class Fam, int NB, bool BASE>
__device__ __forceinline__ void cat_tc_group(bf16* smem, const CatGrad& p,
                                             int m0, int n0, int head0,
                                             int n) {
  float* act = reinterpret_cast<float*>(smem);  // after the mainloop
  const int ldd = p.n_heads * p.fp;
  {
    float acc[NB][kTcMI][4][4];
    const long long w0 = (long long)head0 * p.fp;
    tc_mainloop<NB>(smem,
                    TcOperands{p.h, p.m, p.hp, p.w + w0, ldd, p.fp,
                               (int)(ldd - w0)},
                    m0, n0, acc);
    tc_stage_acts<NB>(act, acc);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = head0 - Fam::kHeads;  // first class of a class group
  float b_l[NB][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gene = n0 + lane + 32 * j;
#pragma unroll
    for (int hd = 0; hd < NB; ++hd)
      b_l[hd][j] = gene < p.f && hd < n ? p.bias[(head0 + hd) * p.f + gene]
                                        : 0.0f;
  }
  float col_acc[NB][2];
#pragma unroll
  for (int hd = 0; hd < NB; ++hd) col_acc[hd][0] = col_acc[hd][1] = 0.0f;

#pragma unroll 2
  for (int r = warp; r < kTcRows && m0 + r < p.m; r += kTcWarps) {
    const int row = m0 + r;
    const long long t_row = (long long)(row % p.m_t) * p.f;
    const float grow = p.g[row];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, gene = n0 + c;
      const bool ok = gene < p.f;
      float a[NB];
#pragma unroll
      for (int hd = 0; hd < NB; ++hd)
        a[hd] = act[(hd * kTcRows + r) * kTcActStride + c] + b_l[hd][j];
      const float tv = ok ? load_t(p.t, p.t_bf16, t_row + gene) : 0.0f;
      float gr[NB];
#pragma unroll
      for (int hd = 0; hd < NB; ++hd) gr[hd] = 0.0f;
      if (ok) {
        if constexpr (BASE) {
          if (tv >= (float)p.k) Fam::grads(a, tv - (float)p.k, nullptr, gr);
        } else {
          const float lv = p.lse[(long long)row * p.f + gene];
#pragma unroll
          for (int hd = 0; hd < NB; ++hd)
            gr[hd] = cat_indicator(tv, c0 + hd, p.k) - expf(a[hd] - lv);
        }
#pragma unroll
        for (int hd = 0; hd < NB; ++hd) gr[hd] *= grow;
      }
      if (gene < p.fp) {
#pragma unroll
        for (int hd = 0; hd < NB; ++hd) {
          if (hd < n) {
            p.da[(long long)row * ldd + (head0 + hd) * p.fp + gene] =
                __float2bfloat16_rn(gr[hd]);
            col_acc[hd][j] += gr[hd];
          }
        }
      }
    }
  }
  tc_store_col_sums<NB>(act, col_acc,
                        p.part + (long long)blockIdx.x * ldd + head0 * p.fp,
                        n0, p.fp, n);
}

// One block per 64 rows (blockIdx.x) x 64 genes (blockIdx.y): the base
// heads, then the classes kCatGroup at a time.
template <class Fam>
__global__ void __launch_bounds__(kTcThreads, 2)
    cat_tc_gradient_kernel(const CatGrad p) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem_raw);
  const int m0 = blockIdx.x * kTcRows, n0 = blockIdx.y * kTcTileN;
  cat_tc_group<Fam, Fam::kHeads, true>(smem, p, m0, n0, 0, Fam::kHeads);
  const int n_classes = p.n_heads - Fam::kHeads;
  for (int c0 = 0; c0 < n_classes; c0 += kCatGroup)
    cat_tc_group<Fam, kCatGroup, false>(smem, p, m0, n0, Fam::kHeads + c0,
                                        min(kCatGroup, n_classes - c0));
}

template <class Fam>
int launch_cat_tc(const CatGrad& p, cudaStream_t stream) {
  const dim3 grid((p.m + kTcRows - 1) / kTcRows,
                  (p.f + kTcTileN - 1) / kTcTileN);
  if (grid.x == 0 || grid.y == 0) return 0;
  constexpr size_t bytes = cat_tc_smem<Fam>();
  auto kernel = cat_tc_gradient_kernel<Fam>;
  if (int err = set_smem(kernel, bytes)) return err;
  kernel<<<grid, kTcThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// Returns a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB, 2 =
// ZIP, 3 = ZINB (the base, NB = 1, 2, 2, 3 heads); n_classes = K + 1 class
// heads after them, NH = NB + n_classes <= 32.  h: bf16 (m, hp); w: bf16
// (hp, NH, fp); b: float32 (NH, f); t:
// (m_t, f), t_dtype 0 = float32, 1 = bfloat16; lse: float32 (m, f); g:
// float32 (m,).  Writes da (m, NH * fp) bf16 and db_part (ceil(m / 64),
// NH * fp) float32.
int scvae_cat_tc_gradient(int family, const float* g, const void* h,
                          const void* w, const float* b,
                          const void* t, int t_dtype, const float* lse,
                          void* da, float* db_part, int m, int m_t, int hp,
                          int f, int n_classes, void* stream) {
  if (n_classes < 2 || t_dtype < 0 || t_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    const CatGrad p{static_cast<const bf16*>(h),
                    static_cast<const bf16*>(w),
                    b,
                    t,
                    t_dtype,
                    lse,
                    g,
                    db_part,
                    static_cast<bf16*>(da),
                    m,
                    m_t,
                    hp,
                    f,
                    (f + 7) / 8 * 8,
                    Fam::kHeads + n_classes,
                    n_classes - 1};
    return launch_cat_tc<Fam>(p, s);
  });
}

}  // extern "C"
