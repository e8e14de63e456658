// The categorised K2 and K3 on the tensor cores, over a Poisson, NB, ZIP or
// ZINB base plus C = K + 1 class-logit heads (up to 32 heads in all), for
// compute_dtype=bfloat16 (the bf16 training path) and for float32
// (precision="float32", the JAX package's choice on any backend but a
// TPU): the forward kernel, and the backward's gradient kernel, whose dh
// and dW are then two plain products of the scratch it writes
// (tc_product.cu).
//
// Replaces the Pallas kernels of scvae_tpu/ops/fused_likelihood.py that
// _fused_forward (K2) and _fused_backward (K3) drive for the categorised
// instances _make_fused_categorised builds (_categorised_ll with
// _cat_select_and_lse, and the grads of _categorised_grads).  Per element,
// with bf16:
//
//   a     = bf16(h) bf16(W) + b for every head   (float32 sums, b unrounded)
//   lse   = logsumexp_c a_c,  sel = a_c at c = min(t, K)
//   ll    = sel - lse + [t >= K] (base_ll(a_base, t - K) - lgamma(1 + t - K))
//   da_c  = g ([min(t, K) = c] - exp(a_c - lse))          class c
//   da_k  = g [t >= K] dbase_ll/da_k (t - K)               base head k
//
// Operands arrive in bf16 from the wrapper: h (M, Hp) and every head's
// weights side by side, W (Hp, NH, Fp) with the base heads first, zero-
// padded to Hp, Fp = multiples of 8.  Both kernels give one block to 64 rows
// x 64 genes and walk the base heads, then the class heads a group at a
// time: each group's products run through the ring of tc_common.cuh with W
// offset by the group's first head.  A head's products do not depend on the
// group it is in, so both kernels compute every activation from the same
// products in the same summation order, and add the same unrounded bias.
// That is deliberate: the backward's exp(a_c - lse) takes the very a_c
// whose exponentials the forward summed into lse.
//
// cat_tc_forward_kernel, classes two at a time: the base group's epilogue
// reads the staged activations a warp per row, its lanes along the genes,
// as the gradient kernel's does: the shifted base log-likelihood where t >=
// K into the row sums, each element's selected class (a byte) into shared
// memory; each thread then keeps its elements' classes in registers.  The
// class groups' epilogue works on the accumulators in place (no staging and
// no barrier): each element's online softmax state (running max, sum of
// exp(a - max)) and the selected class's logit into the thread's row sums.
// The state of a thread's 32 elements stays in registers through every
// group's products.  After the last group the kernel stages lse (M, F) and
// the row sums less lse in shared memory, writes lse a warp per row,
// coalesced, and the block's row sums into a (gene tiles, M) partial array
// that reduce_kernel sums in order: no atomics, results repeat bit for bit.
// The (M, F, C) logits never reach device memory.  Four classes a group
// (accumulators of 128 registers) spill the state; groups of two, with the
// state in registers and two blocks an SM, were the fastest layout that
// ptxas fits in 255 registers.
//
// cat_tc_gradient_kernel: given the forward's lse, each class's gradient
// needs only its own activation, so the groups are independent.  Its
// epilogue writes bf16(da) into the scratch (M, NH * Fp), zero past F, and
// the unrounded column sums of the block's rows into a (row tiles, NH * Fp)
// partial array for db.
//
// Float32 (SEG = kSplitPairs): the split-bf16 design of the base families'
// float32 K2/K3 (count_likelihood_tc.cu, tc_common.cuh).  The entries
// first split h and every head's W into three bf16 terms laid per pair
// (split_pack_kernel: h (M, P, Hp), W (Hp, P, NH, Fp), the base heads from
// their own pointers, then the classes from the class-major (C, H, F)
// weights at a stride); both kernels run each group's ring over the P = 6
// pairs (i, j), i + j < 3, as depth segments, so a head's activation is
// the same sum in both, whatever group it is in.  The forward's softmax
// state and selected classes stay in registers as in bf16: only each
// group's depth grows.  The gradient kernel splits each da into its three
// terms and writes term i of pair q into slot q of the scratch (M, P * NH
// * Fp), whose dh product runs over the depth P * NH * Fp and dW product
// over P * M rows of NH * Fp against h's terms per pair; db sums the
// unrounded da.  The scratch is large: P * NH * Fp bf16 a row, 805,306,368
// elements (1.6 GB) at Poisson-cat's M = 2,048, and 8.05e9 over a
// categorised GMVAE's 20,480 rows.  So every offset into it, into the
// packed W and into the products' operands is 64-bit (the products' TMA
// maps take 64-bit extents; their coordinates, rows and widths, each fit
// 32 bits), and the wrapper runs it whole, without row chunks.
//
// Bounds on the H100 at Poisson-cat's shape (32 heads, M = F = 2,048, H =
// 256): 68.7 GFLOP of head products (0.069 ms at 989 TFLOP/s) per kernel,
// counted once in float32 too (the six pairs are the design's cost, not
// the function's).  The forward moves about 95 MB (h and W in float32 as
// the caller holds them, bf16 t, the row sums and lse; 0.028 ms at 3.35
// TB/s): operations bound it.  The gradient kernel also reads lse and
// writes the bf16 da (268 MB; 0.095 ms): bytes; in float32 the function's
// da is float32 (537 MB; 0.18 ms).  It writes da once, coalesced, and
// never rereads the activations.

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
  bf16* da;            // (m, SEG * NH * fp)
  int m, m_t, hp, f, fp, n_heads, k;
};

// Heads head0 ... head0 + n - 1 (NB slots; slots past n read zeros and are
// not written): the products, then da and its column sums.  BASE: the base
// family's heads (n = NB); otherwise the classes c = head0 - n_base + j.
// SEG = kSplitPairs: the float32 instance, h (M, P Hp) and w (Hp, P, NH,
// Fp) the terms per pair, and da[row][(q NH + hd) fp + gene] the term
// split_first(q) of the value, for each pair q.
template <class Fam, int NB, bool BASE, int SEG>
__device__ __forceinline__ void cat_tc_group(bf16* smem, const CatGrad& p,
                                             int m0, int n0, int head0,
                                             int n) {
  float* act = reinterpret_cast<float*>(smem);  // after the mainloop
  const int width = p.n_heads * p.fp;  // one pair's columns of w and of da
  const long long ldd = (long long)SEG * width;
  {
    float acc[NB][kTcMI][4][4];
    const int w0 = head0 * p.fp;
    tc_mainloop<NB, SEG>(smem,
                         TcOperands{p.h, p.m, p.hp, p.w + w0, ldd, p.fp,
                                    width - w0, width},
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
            bf16* out = p.da + row * ldd + (head0 + hd) * p.fp + gene;
            if constexpr (SEG == 1) {
              *out = __float2bfloat16_rn(gr[hd]);
            } else {
              bf16 term[kSplitTerms];
              split_terms(gr[hd], term);
#pragma unroll
              for (int q = 0; q < SEG; ++q)
                out[q * width] = term[split_first(q)];
            }
            col_acc[hd][j] += gr[hd];
          }
        }
      }
    }
  }
  tc_store_col_sums<NB>(act, col_acc,
                        p.part + (long long)blockIdx.x * width + head0 * p.fp,
                        n0, p.fp, n);
}

// One block per 64 rows (blockIdx.x) x 64 genes (blockIdx.y): the base
// heads, then the classes kCatGroup at a time.
template <class Fam, int SEG>
__global__ void __launch_bounds__(kTcThreads, 2)
    cat_tc_gradient_kernel(const CatGrad p) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem_raw);
  const int m0 = blockIdx.x * kTcRows, n0 = blockIdx.y * kTcTileN;
  cat_tc_group<Fam, Fam::kHeads, true, SEG>(smem, p, m0, n0, 0,
                                            Fam::kHeads);
  const int n_classes = p.n_heads - Fam::kHeads;
  for (int c0 = 0; c0 < n_classes; c0 += kCatGroup)
    cat_tc_group<Fam, kCatGroup, false, SEG>(
        smem, p, m0, n0, Fam::kHeads + c0, min(kCatGroup, n_classes - c0));
}

template <class Fam, int SEG>
int launch_cat_tc(const CatGrad& p, cudaStream_t stream) {
  const dim3 grid((p.m + kTcRows - 1) / kTcRows,
                  (p.f + kTcTileN - 1) / kTcTileN);
  if (grid.x == 0 || grid.y == 0) return 0;
  constexpr size_t bytes = cat_tc_smem<Fam>();
  auto kernel = cat_tc_gradient_kernel<Fam, SEG>;
  if (int err = set_smem(kernel, bytes)) return err;
  kernel<<<grid, kTcThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward

// Class heads per group of the forward: two keep the softmax state in
// registers beside the accumulators.
constexpr int kCatFwdGroup = 2;

// A thread's elements of the block's tile, in the accumulators' layout of
// tc_mainloop: rows wm * 32 + 16 mi + lane / 4 + 8 half (row q = 2 mi +
// half of the thread) and genes wn * 32 + 8 ni + 2 (lane % 4) + e2, element
// e = (4 q + ni) * 2 + e2 at acc[.][mi][ni][2 half + e2].
constexpr int kCatRowsQ = 2 * kTcMI;
constexpr int kCatElems = kCatRowsQ * 4 * 2;
// A selected class that no class matches (an element outside M x F).
constexpr uint32_t kNoClass = 0xff;

// The operands of the forward.
struct CatFwd {
  const bf16* h;
  const bf16* w;
  const float* bias;  // (NH, f)
  const void* t;
  int t_bf16;
  float* part;        // (gene tiles, m)
  float* lse;         // (m, f)
  int m, m_t, hp, f, fp, n_heads, k;
};

// Shared memory of the base group's epilogue past its staged activations:
// each element's selected class, a byte, and each row's base sum.
constexpr size_t kCatBaseExtra = kTcRows * kTcTileN + sizeof(float) * kTcRows;

// Dynamic shared memory of the forward: the ring of a class group, or the
// base group's staged activations and classes, whichever is larger; the
// last pass's staged lse and row sums fit in the latter.
template <class Fam>
constexpr size_t cat_fwd_smem() {
  constexpr size_t base = tc_heads_smem<Fam::kHeads>() + kCatBaseExtra;
  constexpr size_t ring = TcSmem<kCatFwdGroup>::kBytes;
  static_assert(sizeof(float) * (kTcRows * kTcActStride + kTcWarpsN * kTcRows)
                    <= base,
                "the staged lse fits");
  return base > ring ? base : ring;
}

// The base family's heads: the products, staged in shared memory, then an
// epilogue a warp per row, its lanes along the genes, as the gradient
// kernel's (a loop, not unrolled: the base log-likelihoods are long, and a
// warp whose row holds no t >= K skips them).  The shifted base
// log-likelihood where t >= K is summed per row into rb[64], and each
// element's selected class min(t, K) goes into cls[64][64], a byte each (the
// select of _cat_select_and_lse: the last class c <= K with t >= c, else
// class 0; kNoClass outside M x F).  Then each thread gathers its elements'
// classes into sel and its rows' sums into row_ll (one thread per row: lane
// % 4 = 0 of the warps wn = 0).
template <class Fam, int SEG>
__device__ __forceinline__ void cat_fwd_base(bf16* smem, const CatFwd& p,
                                             int m0, int n0,
                                             float (&row_ll)[kCatRowsQ],
                                             uint32_t (&sel)[kCatElems / 4]) {
  constexpr int NB = Fam::kHeads;
  float* act = reinterpret_cast<float*>(smem);  // after the mainloop
  uint8_t* cls =
      reinterpret_cast<uint8_t*>(act + NB * kTcRows * kTcActStride);
  float* rb = reinterpret_cast<float*>(cls + kTcRows * kTcTileN);
  {
    const int width = p.n_heads * p.fp;
    float acc[NB][kTcMI][4][4];
    tc_mainloop<NB, SEG>(smem,
                         TcOperands{p.h, p.m, p.hp, p.w,
                                    (long long)SEG * width, p.fp, width,
                                    width},
                         m0, n0, acc);
    tc_stage_acts<NB>(act, acc);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float b_l[NB][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gene = n0 + lane + 32 * j;
#pragma unroll
    for (int hd = 0; hd < NB; ++hd)
      b_l[hd][j] = gene < p.f ? p.bias[hd * p.f + gene] : 0.0f;
  }
#pragma unroll 1
  for (int r = warp; r < kTcRows; r += kTcWarps) {
    const int row = m0 + r;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, gene = n0 + c;
      uint32_t cl = kNoClass;
      if (row < p.m && gene < p.f) {
        const float tv =
            load_t(p.t, p.t_bf16, (long long)(row % p.m_t) * p.f + gene);
        cl = tv >= (float)p.k ? (uint32_t)p.k
                              : (tv >= 1.0f ? (uint32_t)tv : 0u);
        if (tv >= (float)p.k) {
          float a[NB];
#pragma unroll
          for (int hd = 0; hd < NB; ++hd)
            a[hd] = act[(hd * kTcRows + r) * kTcActStride + c] + b_l[hd][j];
          const float shifted = tv - (float)p.k;
          sum += Fam::ll(a, shifted) - series_lgamma(1.0f + shifted);
        }
      }
      cls[r * kTcTileN + c] = (uint8_t)cl;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) rb[r] = sum;
  }
  __syncthreads();

  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
#pragma unroll
  for (int i = 0; i < kCatElems / 4; ++i) sel[i] = 0u;
#pragma unroll
  for (int q = 0; q < kCatRowsQ; ++q) {
    const int r = wm * 32 + 16 * (q / 2) + (lane >> 2) + 8 * (q % 2);
    row_ll[q] = wn == 0 && (lane & 3) == 0 ? rb[r] : 0.0f;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int c = wn * 32 + ni * 8 + 2 * (lane & 3) + e2;
        const int e = (4 * q + ni) * 2 + e2;
        sel[e / 4] |= (uint32_t)cls[r * kTcTileN + c] << (8 * (e % 4));
      }
  }
  __syncthreads();  // every gather is done before the ring refills
}

// The classes c = head0 - n_base + hd for hd < n (NB slots; slots past n
// read zeros and are not used): the products, then an epilogue straight
// from the accumulators (it reads no shared memory, so the next group's
// loads may start at once): each element's online softmax state, and the
// selected class's logit into row_ll.  st: each element's (running max,
// sum of exp(a - max)).
template <class Fam, int NB, int SEG>
__device__ __forceinline__ void cat_fwd_classes(
    bf16* smem, const CatFwd& p, int m0, int n0, int head0, int n,
    float (&row_ll)[kCatRowsQ], const uint32_t (&sel)[kCatElems / 4],
    float2 (&st)[kCatElems]) {
  const int width = p.n_heads * p.fp;
  float acc[NB][kTcMI][4][4];
  const int w0 = head0 * p.fp;
  tc_mainloop<NB, SEG>(smem,
                       TcOperands{p.h, p.m, p.hp, p.w + w0,
                                  (long long)SEG * width, p.fp, width - w0,
                                  width},
                       m0, n0, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % kTcWarpsN;
  const int c0 = head0 - Fam::kHeads;  // the group's first class
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int gene = n0 + wn * 32 + ni * 8 + 2 * (lane & 3) + e2;
      float b[NB];
#pragma unroll
      for (int hd = 0; hd < NB; ++hd)
        b[hd] = gene < p.f && hd < n ? p.bias[(head0 + hd) * p.f + gene]
                                     : 0.0f;
#pragma unroll
      for (int q = 0; q < kCatRowsQ; ++q) {
        const int e = (4 * q + ni) * 2 + e2;
        const uint32_t cls = (sel[e / 4] >> (8 * (e % 4))) & 0xffu;
        float2 s = st[e];
#pragma unroll
        for (int hd = 0; hd < NB; ++hd) {
          if (hd < n) {
            const float a = acc[hd][q / 2][ni][2 * (q % 2) + e2] + b[hd];
            // one exponential a class: the smaller of exp(a - max) and
            // exp(max - a), the latter rescaling the sum to a new max
            const float d = a - s.x;
            const float ex = expf(-fabsf(d));
            s.y = d > 0.0f ? fmaf(s.y, ex, 1.0f) : s.y + ex;
            s.x = fmaxf(s.x, a);
            if (cls == (uint32_t)(c0 + hd)) row_ll[q] += a;
          }
        }
        st[e] = s;
      }
    }
  }
}

// One block per 64 rows (blockIdx.x) x 64 genes (blockIdx.y): the base
// heads, then the classes kCatFwdGroup at a time; then lse and the row sums
// less lse, staged in shared memory and written a warp per row.
template <class Fam, int SEG>
__global__ void __launch_bounds__(kTcThreads, 2)
    cat_tc_forward_kernel(const CatFwd p) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem_raw);
  const int m0 = blockIdx.x * kTcRows, n0 = blockIdx.y * kTcTileN;
  float row_ll[kCatRowsQ];
  uint32_t sel[kCatElems / 4];
  cat_fwd_base<Fam, SEG>(smem, p, m0, n0, row_ll, sel);
  float2 st[kCatElems];
#pragma unroll
  for (int e = 0; e < kCatElems; ++e) st[e] = make_float2(-INFINITY, 0.0f);
  const int n_classes = p.n_heads - Fam::kHeads;
  for (int c0 = 0; c0 < n_classes; c0 += kCatFwdGroup)
    cat_fwd_classes<Fam, kCatFwdGroup, SEG>(
        smem, p, m0, n0, Fam::kHeads + c0, min(kCatFwdGroup, n_classes - c0),
        row_ll, sel, st);

  // lse into stage[64][kTcActStride]; each row's sum over the warp's genes
  // less lse into red[wn][64] (the ring is free: the last mainloop ended
  // with a barrier, and the epilogue reads no shared memory)
  float* stage = reinterpret_cast<float*>(tc_smem_raw);
  float* red = stage + kTcRows * kTcActStride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
#pragma unroll
  for (int q = 0; q < kCatRowsQ; ++q) {
    const int r = wm * 32 + 16 * (q / 2) + (lane >> 2) + 8 * (q % 2);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int c = wn * 32 + ni * 8 + 2 * (lane & 3) + e2;
        const float2 s = st[(4 * q + ni) * 2 + e2];
        const float lse = s.x + logf(s.y);
        stage[r * kTcActStride + c] = lse;
        if (m0 + r < p.m && n0 + c < p.f) row_ll[q] -= lse;
      }
    }
    float sum = row_ll[q];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((lane & 3) == 0) red[wn * kTcRows + r] = sum;
  }
  __syncthreads();
  for (int r = warp; r < kTcRows && m0 + r < p.m; r += kTcWarps) {
    const int row = m0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gene = n0 + lane + 32 * j;
      if (gene < p.f)
        p.lse[(long long)row * p.f + gene] =
            stage[r * kTcActStride + lane + 32 * j];
    }
    if (lane == 0) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kTcWarpsN; ++w) sum += red[w * kTcRows + r];
      p.part[(long long)blockIdx.y * p.m + row] = sum;
    }
  }
}

template <class Fam, int SEG>
int launch_cat_tc_forward(const CatFwd& p, cudaStream_t stream) {
  const dim3 grid((p.m + kTcRows - 1) / kTcRows,
                  (p.f + kTcTileN - 1) / kTcTileN);
  if (grid.x == 0 || grid.y == 0) return 0;
  constexpr size_t bytes = cat_fwd_smem<Fam>();
  auto kernel = cat_tc_forward_kernel<Fam, SEG>;
  if (int err = set_smem(kernel, bytes)) return err;
  kernel<<<grid, kTcThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB,
// 2 = ZIP, 3 = ZINB (the base, NB = 1, 2, 2, 3 heads); n_classes = K + 1
// class heads after them, NH = NB + n_classes <= 32.  h: bf16 (m, hp); w:
// bf16 (hp, NH, fp); b: float32 (NH, f); t: (m_t, f), t_dtype 0 = float32,
// 1 = bfloat16, row m reading target row m % m_t.  The float32 entries
// (scvae_cat_tc_f32_*) take float32 h and W instead and split them first
// (below); the forward's outputs are the bf16 one's.

// K2: part (ceil(f / 64), m) float32 scratch; writes out (m,) and lse
// (m, f), float32.
int scvae_cat_tc_forward(int family, const void* h, const void* w,
                         const float* b, const void* t, int t_dtype,
                         float* part, float* out, float* lse, int m, int m_t,
                         int hp, int f, int n_classes, void* stream) {
  if (n_classes < 2 || t_dtype < 0 || t_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    const CatFwd p{static_cast<const bf16*>(h),
                   static_cast<const bf16*>(w),
                   b,
                   t,
                   t_dtype,
                   part,
                   lse,
                   m,
                   m_t,
                   hp,
                   f,
                   (f + 7) / 8 * 8,
                   Fam::kHeads + n_classes,
                   n_classes - 1};
    return launch_cat_tc_forward<Fam, 1>(p, s);
  });
  if (err) return err;
  return launch_reduce(part, (f + kTcTileN - 1) / kTcTileN, m, out, s);
}

// K3, first half: lse float32 (m, f) from the forward, g float32 (m,);
// writes da (m, NH * fp) bf16 and db_part (ceil(m / 64), NH * fp) float32.
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
    return launch_cat_tc<Fam, 1>(p, s);
  });
}

// The float32 K2: h (m, hidden) and every head's W in float32 (the base
// heads w0, w1, w2, null past the family's, then the class-major cat_w
// (n_classes, hidden, f)) split into their terms per pair in the scratch hh
// (m, P, hp) and wp (hp, P, NH, fp), P = kSplitPairs; then as
// scvae_cat_tc_forward on those.
int scvae_cat_tc_f32_forward(int family, const float* h, const float* w0,
                             const float* w1, const float* w2,
                             const float* cat_w, const float* b,
                             const void* t, int t_dtype, void* hh, void* wp,
                             float* part, float* out, float* lse, int m,
                             int m_t, int hidden, int f, int n_classes,
                             void* stream) {
  if (n_classes < 2 || t_dtype < 0 || t_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = (hidden + 7) / 8 * 8, fp = (f + 7) / 8 * 8;
  const int err = with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    if (int e = launch_split_operands(Fam::kHeads, h, w0, w1, w2, cat_w,
                                      n_classes, static_cast<bf16*>(hh),
                                      static_cast<bf16*>(wp), m, hidden, hp,
                                      f, fp, s))
      return e;
    const CatFwd p{static_cast<const bf16*>(hh),
                   static_cast<const bf16*>(wp),
                   b,
                   t,
                   t_dtype,
                   part,
                   lse,
                   m,
                   m_t,
                   hp,
                   f,
                   fp,
                   Fam::kHeads + n_classes,
                   n_classes - 1};
    return launch_cat_tc_forward<Fam, kSplitPairs>(p, s);
  });
  if (err) return err;
  return launch_reduce(part, (f + kTcTileN - 1) / kTcTileN, m, out, s);
}

// The float32 K3, first half: the operands' split into hh and wp, which the
// products read after it, then da (m, P * NH * fp) bf16 scratch of da's
// terms per pair and db_part (ceil(m / 64), NH * fp) float32 scratch.
int scvae_cat_tc_f32_gradient(int family, const float* g, const float* h,
                              const float* w0, const float* w1,
                              const float* w2, const float* cat_w,
                              const float* b, const void* t, int t_dtype,
                              const float* lse, void* hh, void* wp, void* da,
                              float* db_part, int m, int m_t, int hidden,
                              int f, int n_classes, void* stream) {
  if (n_classes < 2 || t_dtype < 0 || t_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = (hidden + 7) / 8 * 8, fp = (f + 7) / 8 * 8;
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    if (int e = launch_split_operands(Fam::kHeads, h, w0, w1, w2, cat_w,
                                      n_classes, static_cast<bf16*>(hh),
                                      static_cast<bf16*>(wp), m, hidden, hp,
                                      f, fp, s))
      return e;
    const CatGrad p{static_cast<const bf16*>(hh),
                    static_cast<const bf16*>(wp),
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
                    fp,
                    Fam::kHeads + n_classes,
                    n_classes - 1};
    return launch_cat_tc<Fam, kSplitPairs>(p, s);
  });
}

}  // extern "C"
