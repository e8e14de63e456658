// K2 / K3 with bf16 operands on the tensor cores: the fused decoder heads
// and count log-likelihood of the Poisson, NB, ZIP and ZINB families,
// forward and backward, for compute_dtype=bfloat16 (the training path).
//
// Replaces, for bf16 inputs, the Pallas kernels of
// scvae_tpu/ops/fused_likelihood.py: _make_forward_kernel driven by
// _fused_forward (K2) and _make_backward_kernel driven by _fused_backward
// (K3).  The float32 instances keep the CUDA-core kernels of
// count_likelihood.cu.  For M rows of h (M, H) and the family's heads
// W_k (H, F), b_k (F,):
//
//   a_k  = bf16(h) bf16(W_k) + b_k     (float32 sums, b_k unrounded)
//   ll   = sum_f log p(t | a)          (support clips; -lgamma(1 + t) if asked)
//   da_k = g * dll/da_k                (float32; zero outside each clip range)
//   dh   = sum_k bf16(da_k) W_k^T,  dW_k = h^T bf16(da_k),  db_k = sum_rows da_k
//
// Operands arrive in bf16 from the wrapper: h (M, Hp) and the heads'
// weights side by side, W (Hp, NH, Fp), zero-padded to Hp, Fp = multiples
// of 8 so that every row starts on 16 bytes.  Four kernels:
//
//   tc_heads_kernel<Fam, false>  forward: one block per 64 rows x 64
//       genes, all NH heads; writes the block's row sums of ll to a
//       (gene tiles, M) partial array.
//   tc_heads_kernel<Fam, true>   the same products, then da_k: rounded
//       to bf16 into a (M, NH * Fp) scratch, and the unrounded column sums
//       of the block's rows into a (row tiles, NH * Fp) partial array.
//   tc_gemm_kernel<false, true>      dh = da W^T over K = NH * Fp, and
//   tc_gemm_kernel<true, false>      dW = h^T da over K = M: plain products
//       of the scratch, split over K into partial arrays.
//   reduce_kernel                    sums partial arrays over their first
//       axis in order into the outputs.
//
// So the backward computes the activations and the transcendentals once
// (the CUDA-core version recomputed them in its dW pass), and every
// cross-block sum is a second pass in a fixed order: no atomics, results
// repeat bit for bit.
//
// Bound on the H100 at the headline shape (M = F = 2048, H = 256): the head
// products, 2 * heads * M * H * F FLOP (2.15 GFLOP per head) per product,
// against h + heads * (W + b) + t bytes; one or two heads are bound by
// bytes at 3.35 TB/s, three by operations at 989 TFLOP/s.  What the design
// does about it: the products run as mma.sync m16n8k16 bf16 with float32
// accumulators (wgmma is the way to the full rate; mma.sync keeps fragment
// layouts that a syntax check and a short chip call can verify, and the
// products are a small share of these kernels' time), fed by ldmatrix from
// shared memory that a ring of four stages of 32 hidden units (or rows, or
// genes) fills with cp.async, so the copies of the next stages overlap the
// products of this one and shared memory is bounded by the ring for any H.
// A block of 64 rows x 64 genes (1,024 blocks at the headline shape, 10,240
// over the GMVAE's 20,480 rows) asks for 16 warps per SM (12 for three
// heads).  The epilogue's float32 transcendentals, not the products, set
// the heads kernels' time.  The heads kernels sum each mma's products into
// zeros and add the result in float32: inside an mma the running sum would
// be aligned with the products and truncate them alike.  The bf16 da
// scratch (8 MB per head at 2,048 rows) costs little next to recomputing
// the activations a second time.

#include <stdint.h>

#include "count_families.cuh"

namespace scvae {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcDepth = 32;   // depth (k) of one ring stage
constexpr int kTcStages = 4;   // stages of the ring
constexpr int kTcTileN = 64;   // columns of a block: two warps of 32
constexpr int kTcWarpsN = 2;
constexpr int kTcPad = 8;      // bf16 padding per shared row (no bank conflicts)
constexpr int kTcHeadsRows = 64;     // rows of a heads block
constexpr int kTcProductRows = 128;  // rows of a dh / dW product block
constexpr int kTcReduceThreads = 256;

// A block of BM rows: warps of MI m16 tiles (16 MI rows) x 32 columns.
template <int BM, int MI>
struct TcShape {
  static_assert(BM % (16 * MI) == 0, "whole warps of rows");
  static constexpr int kWarpsM = BM / (16 * MI);
  static constexpr int kThreads = 32 * kWarpsM * kTcWarpsN;
};
constexpr int kTcHeadsMI = 2;    // heads kernels: 32 x 32 warp tiles
constexpr int kTcProductMI = 4;  // products: 64 x 32 warp tiles

// Blocks per SM that the heads kernels ask the compiler to fit: 16 warps,
// or 12 for three heads, whose accumulators take more registers.
template <int BM, int NH>
constexpr int tc_heads_min_blocks() {
  constexpr int t = TcShape<BM, kTcHeadsMI>::kThreads;
  constexpr int warps = NH >= 3 ? 12 : 16;
  return 32 * warps / t > 1 ? 32 * warps / t : 1;
}

// Shared memory of one ring stage: the A tile and NB tiles of B, stored as
// the operands lie in device memory (AT: A as [k][m]; BT: B as [n][k]).
template <int BM, int NB, bool AT, bool BT>
struct TcSmem {
  static constexpr int kA =
      AT ? kTcDepth * (BM + kTcPad) : BM * (kTcDepth + kTcPad);
  static constexpr int kB =
      BT ? kTcTileN * (kTcDepth + kTcPad) : kTcDepth * (kTcTileN + kTcPad);
  static constexpr int kStage = kA + NB * kB;  // bf16 elements
  static constexpr size_t kBytes = sizeof(bf16) * kStage * kTcStages;
};

// The operands of one product A (M x K) times B (K x N).  A lies in device
// memory as [m][k] (row stride lda) or, for AT, as [k][m]; B as [k][n] or,
// for BT, as [n][k].  NB tiles of B sit b_head columns apart (the heads).
// m_max, n_max and k_max bound the valid rows, columns and depth; a bound
// that falls inside a 16-byte chunk of a stored row is a multiple of 8.
struct TcOperands {
  const bf16* a;
  long long lda;
  int m_max;
  const bf16* b;
  long long ldb;
  int b_head;
  int n_max;
  int k_max;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled when !valid.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile, bf16 inputs, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An R x C tile (C a multiple of 8) at (r0, c0) of a row-major bf16 array
// with row stride ld into shared memory (row stride C + kTcPad), one
// 16-byte chunk per copy; chunks outside (r_max, c_max) are zero.
template <int R, int C, int NT>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld,
                                          int r0, int c0, int r_max,
                                          int c_max) {
  constexpr int kRowChunks = C / 8;
  constexpr int kChunks = R * kRowChunks;
  static_assert(kChunks % NT == 0, "every thread copies whole chunks");
#pragma unroll
  for (int i = 0; i < kChunks / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / kRowChunks, c = (idx % kRowChunks) * 8;
    const int gr = r0 + r, gc = c0 + c;
    const bool valid = gr < r_max && gc < c_max;
    const bf16* src = valid ? g + (long long)gr * ld + gc : g;
    cp_async_16(smem_u32(s + r * (C + kTcPad) + c), src, valid);
  }
}

// acc[hd] += A[m0 : m0 + BM, K] B_hd[K, n0 : n0 + 64] over the depth tiles
// [kt0, kt1) through the ring.  Warp (wm, wn) owns rows wm * 16 MI + [0, 16
// MI) and columns wn * 32 + [0, 32): acc[hd][mi][ni] is the m16n8 tile at
// rows + 16 mi, columns + 8 ni.  Shared memory is free again on return.
// PROMOTE: each mma sums its 16 products into zeros and the result is added
// to acc by a float32 add.  An mma aligns its products to the largest term,
// the running sum included, and drops the bits below, so a large running
// sum inside the mma truncates every later product the same way; outside,
// the sums round to nearest like the plain version's float32 product.
template <int BM, int MI, int NB, bool AT, bool BT, bool PROMOTE>
__device__ __forceinline__ void tc_mainloop(bf16* smem, const TcOperands& op,
                                            int m0, int n0, int kt0, int kt1,
                                            float (&acc)[NB][MI][4][4]) {
  using S = TcSmem<BM, NB, AT, BT>;
  constexpr int NT = TcShape<BM, MI>::kThreads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;

  auto load = [&](int stage, int kt) {
    bf16* sa = smem + stage * S::kStage;
    bf16* sb = sa + S::kA;
    const int k0 = kt * kTcDepth;
    if constexpr (AT)
      load_tile<kTcDepth, BM, NT>(sa, op.a, op.lda, k0, m0, op.k_max,
                                  op.m_max);
    else
      load_tile<BM, kTcDepth, NT>(sa, op.a, op.lda, m0, k0, op.m_max,
                                  op.k_max);
#pragma unroll
    for (int hd = 0; hd < NB; ++hd) {
      const int n = n0 + hd * op.b_head;
      if constexpr (BT)
        load_tile<kTcTileN, kTcDepth, NT>(sb + hd * S::kB, op.b, op.ldb, n,
                                          k0, op.n_max, op.k_max);
      else
        load_tile<kTcDepth, kTcTileN, NT>(sb + hd * S::kB, op.b, op.ldb, k0,
                                          n, op.k_max, op.n_max);
    }
  };

  auto compute = [&](int stage) {
    const bf16* sa = smem + stage * S::kStage;
    const bf16* sb = sa + S::kA;
#pragma unroll
    for (int kk = 0; kk < kTcDepth; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int mb = wm * 16 * MI + mi * 16;
        if constexpr (AT) {
          const int k = kk + (lane & 7) + ((lane >> 4) << 3);
          const int m = mb + (((lane >> 3) & 1) << 3);
          ldsm_x4_t(af[mi], smem_u32(sa + k * (BM + kTcPad) + m));
        } else {
          const int m = mb + (lane & 15);
          const int k = kk + ((lane >> 4) << 3);
          ldsm_x4(af[mi], smem_u32(sa + m * (kTcDepth + kTcPad) + k));
        }
      }
#pragma unroll
      for (int hd = 0; hd < NB; ++hd) {
        const bf16* sbh = sb + hd * S::kB;
        uint32_t bfr[4][2];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int nb = wn * 32 + nj * 16;
          uint32_t r[4];
          if constexpr (BT) {
            const int n = nb + (lane & 7) + ((lane >> 4) << 3);
            const int k = kk + (((lane >> 3) & 1) << 3);
            ldsm_x4(r, smem_u32(sbh + n * (kTcDepth + kTcPad) + k));
          } else {
            const int k = kk + (lane & 7) + (((lane >> 3) & 1) << 3);
            const int n = nb + ((lane >> 4) << 3);
            ldsm_x4_t(r, smem_u32(sbh + k * (kTcTileN + kTcPad) + n));
          }
          bfr[2 * nj][0] = r[0];
          bfr[2 * nj][1] = r[1];
          bfr[2 * nj + 1][0] = r[2];
          bfr[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
          {
            if constexpr (PROMOTE) {
              float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_bf16(part, af[mi], bfr[ni][0], bfr[ni][1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[hd][mi][ni][e] += part[e];
            } else {
              mma_bf16(acc[hd][mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
            }
          }
      }
    }
  };

  const int n_k = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_k) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<kTcStages - 2>();  // stage i has landed
    __syncthreads();                 // and stage i - 1 is read by all
    const int next = i + kTcStages - 1;
    if (next < n_k) load(next % kTcStages, kt0 + next);
    cp_async_commit();
    compute(i % kTcStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float load_t(const void* t, int t_bf16,
                                        long long i) {
  return t_bf16 ? __bfloat162float(static_cast<const bf16*>(t)[i])
                : static_cast<const float*>(t)[i];
}

// Shared row stride of the staged activations: 64 columns and a pad that
// keeps the accumulators' float2 stores free of bank conflicts.
constexpr int kTcActStride = kTcTileN + 8;

template <int BM, int NH>
struct TcHeadsSmem {
  static constexpr size_t kRing = TcSmem<BM, NH, false, false>::kBytes;
  static constexpr size_t kActs = sizeof(float) * NH * BM * kTcActStride;
  static constexpr size_t kBytes = kRing > kActs ? kRing : kActs;
};

// The heads' products of a block of 64 rows x 64 genes, then its epilogue.
// The accumulators are staged in shared memory as act[hd][row][col]; then
// each warp takes rows in turn, its lanes the columns lane and lane + 32, so
// that the targets load and the da scratch stores coalesce and the
// epilogue's code stays one loop.
// GRAD = false (K2): part[blockIdx.y][row] = the block's sum over its genes
// of ll (minus lgamma(1 + t) if asked).  GRAD = true (K3, first half):
// da[row][hd * fp + gene] = bf16(g[row] dll/da_hd), zero past F, and
// part[blockIdx.x][hd * fp + gene] = the block's sum over its rows of the
// unrounded values.  Targets t (m_t, f) are float32 or (t_bf16) bf16; row
// m reads target row m % m_t.
template <class Fam, bool GRAD>
__global__ void __launch_bounds__(TcShape<kTcHeadsRows, kTcHeadsMI>::kThreads,
                                  tc_heads_min_blocks<kTcHeadsRows,
                                                      Fam::kHeads>())
    tc_heads_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const float* __restrict__ bias, const void* __restrict__ t,
                    int t_bf16, const float* __restrict__ g,
                    float* __restrict__ part, bf16* __restrict__ da, int m,
                    int m_t, int hp, int f, int fp, int subtract_const) {
  constexpr int NH = Fam::kHeads;
  constexpr int BM = kTcHeadsRows, MI = kTcHeadsMI;
  constexpr int NT = TcShape<BM, MI>::kThreads;
  constexpr int kWarps = NT / 32;
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem_raw);
  float* act = reinterpret_cast<float*>(tc_smem_raw);  // after the mainloop

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kTcTileN;
  const int ldd = NH * fp;
  const TcOperands op{h, hp, m, w, ldd, fp, ldd, hp};
  float acc[NH][MI][4][4];
#pragma unroll
  for (int hd = 0; hd < NH; ++hd)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[hd][mi][ni][e] = 0.0f;
  tc_mainloop<BM, MI, NH, false, false, true>(
      smem, op, m0, n0, 0, (hp + kTcDepth - 1) / kTcDepth, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  {
    const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
#pragma unroll
    for (int hd = 0; hd < NH; ++hd)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 16 * MI + mi * 16 + (lane >> 2) + half * 8;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int c = wn * 32 + ni * 8 + 2 * (lane & 3);
            *reinterpret_cast<float2*>(act + (hd * BM + r) * kTcActStride +
                                       c) =
                make_float2(acc[hd][mi][ni][half * 2],
                            acc[hd][mi][ni][half * 2 + 1]);
          }
        }
  }
  __syncthreads();

  float b_l[NH][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gene = n0 + lane + 32 * j;
#pragma unroll
    for (int hd = 0; hd < NH; ++hd)
      b_l[hd][j] = gene < f ? bias[hd * f + gene] : 0.0f;
  }
  float col_acc[NH][2];
#pragma unroll
  for (int hd = 0; hd < NH; ++hd) col_acc[hd][0] = col_acc[hd][1] = 0.0f;

#pragma unroll 2
  for (int r = warp; r < BM && m0 + r < m; r += kWarps) {
    const int row = m0 + r;
    const long long t_row = (long long)(row % m_t) * f;
    const float grow = GRAD ? g[row] : 0.0f;
    float row_ll = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, gene = n0 + c;
      const bool ok = gene < f;
      float a[NH];
#pragma unroll
      for (int hd = 0; hd < NH; ++hd)
        a[hd] = act[(hd * BM + r) * kTcActStride + c] + b_l[hd][j];
      const float tv = ok ? load_t(t, t_bf16, t_row + gene) : 0.0f;
      if constexpr (!GRAD) {
        if (ok) {
          float ll = Fam::ll(a, tv);
          if (subtract_const) ll -= series_lgamma(1.0f + tv);
          row_ll += ll;
        }
      } else {
        float gr[NH];
#pragma unroll
        for (int hd = 0; hd < NH; ++hd) gr[hd] = 0.0f;
        if (ok) {
          Fam::grads(a, tv, nullptr, gr);
#pragma unroll
          for (int hd = 0; hd < NH; ++hd) gr[hd] *= grow;
        }
        if (gene < fp) {
#pragma unroll
          for (int hd = 0; hd < NH; ++hd) {
            da[(long long)row * ldd + hd * fp + gene] =
                __float2bfloat16_rn(gr[hd]);
            col_acc[hd][j] += gr[hd];
          }
        }
      }
    }
    if constexpr (!GRAD) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        row_ll += __shfl_xor_sync(0xffffffffu, row_ll, off);
      if (lane == 0) part[(long long)blockIdx.y * m + row] = row_ll;
    }
  }

  if constexpr (GRAD) {
    // column sums: each warp's rows, then the warps in order
    __syncthreads();  // every warp is done reading act
    float* red = act;  // [kWarps][NH][64]
#pragma unroll
    for (int hd = 0; hd < NH; ++hd)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red[(warp * NH + hd) * kTcTileN + lane + 32 * j] = col_acc[hd][j];
    __syncthreads();
    for (int c = threadIdx.x; c < NH * kTcTileN; c += NT) {
      const int hd = c / kTcTileN, cl = c % kTcTileN;
      const int gene = n0 + cl;
      if (gene < fp) {
        float s = 0.0f;
        for (int j = 0; j < kWarps; ++j) s += red[(j * NH + hd) * kTcTileN + cl];
        part[(long long)blockIdx.x * ldd + hd * fp + gene] = s;
      }
    }
  }
}

// One product block of kTcProductRows x 64 outputs over the depth tiles of
// split blockIdx.z, into part[blockIdx.z] (op.m_max x op.n_max, row-major).
// The da scratch is the operand that does not fit in L2 (168 MB for NB over
// 20,480 rows), so the blocks that read the same da tiles run next to each
// other: for dh (da is A) the column tiles vary fastest (blockIdx.x), for
// dW (da is B) the row tiles.
template <bool AT, bool BT>
__global__ void __launch_bounds__(TcShape<kTcProductRows,
                                          kTcProductMI>::kThreads)
    tc_gemm_kernel(TcOperands op, float* __restrict__ part,
                   int tiles_per_split) {
  constexpr int BM = kTcProductRows, MI = kTcProductMI;
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem_raw);
  const int m0 = (BT ? blockIdx.y : blockIdx.x) * BM;
  const int n0 = (BT ? blockIdx.x : blockIdx.y) * kTcTileN;
  const int k_tiles = (op.k_max + kTcDepth - 1) / kTcDepth;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, k_tiles);
  float acc[1][MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][mi][ni][e] = 0.0f;
  tc_mainloop<BM, MI, 1, AT, BT, false>(smem, op, m0, n0, kt0,
                                        max(kt0, kt1), acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
  float* out = part + (long long)blockIdx.z * op.m_max * op.n_max;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 16 * MI + mi * 16 + (lane >> 2) + half * 8;
      if (row >= op.m_max) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = n0 + wn * 32 + ni * 8 + 2 * (lane & 3) + e2;
          if (col < op.n_max)
            out[(long long)row * op.n_max + col] = acc[0][mi][ni][half * 2 + e2];
        }
    }
}

// out[c / seg][r][c % seg] (strides out_seg, out_ld) = sum over s < n_slices,
// in order, of part[s][r][c] (an n_slices x rows x cols array), for
// r < valid_r and c % seg < valid_c.
__global__ void __launch_bounds__(kTcReduceThreads)
    reduce_kernel(const float* __restrict__ part, int n_slices, int rows,
                  int cols, int seg, int valid_r, int valid_c,
                  float* __restrict__ out, long long out_seg, int out_ld) {
  const long long n = (long long)rows * cols;
  const long long slice = n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / cols), c = (int)(i % cols);
    const int hd = c / seg, cc = c - hd * seg;
    if (r >= valid_r || cc >= valid_c) continue;
    float s = 0.0f;
    for (int j = 0; j < n_slices; ++j) s += part[j * slice + i];
    out[hd * out_seg + (long long)r * out_ld + cc] = s;
  }
}

int launch_reduce(const float* part, int n_slices, int rows, int cols,
                  int seg, int valid_r, int valid_c, float* out,
                  long long out_seg, int out_ld, cudaStream_t stream) {
  const long long n = (long long)rows * cols;
  if (n == 0) return 0;
  const long long wanted = (n + kTcReduceThreads - 1) / kTcReduceThreads;
  const long long blocks = wanted < 132LL * 16 ? wanted : 132LL * 16;
  reduce_kernel<<<(int)blocks, kTcReduceThreads, 0, stream>>>(
      part, n_slices, rows, cols, seg, valid_r, valid_c, out, out_seg,
      out_ld);
  return (int)cudaGetLastError();
}

template <class Fam, bool GRAD>
int launch_heads(const bf16* h, const bf16* w, const float* b, const void* t,
                 int t_bf16, const float* g, float* part, bf16* da, int m,
                 int m_t, int hp, int f, int subtract_const,
                 cudaStream_t stream) {
  constexpr int BM = kTcHeadsRows;
  const dim3 grid((m + BM - 1) / BM, (f + kTcTileN - 1) / kTcTileN);
  if (grid.x == 0 || grid.y == 0) return 0;
  const size_t bytes = TcHeadsSmem<BM, Fam::kHeads>::kBytes;
  auto kernel = tc_heads_kernel<Fam, GRAD>;
  if (int err = set_smem(kernel, bytes)) return err;
  const int fp = (f + 7) / 8 * 8;
  kernel<<<grid, TcShape<BM, kTcHeadsMI>::kThreads, bytes, stream>>>(
      h, w, b, t, t_bf16, g, part, da, m, m_t, hp, f, fp, subtract_const);
  return (int)cudaGetLastError();
}

template <bool AT, bool BT>
int launch_product(const TcOperands& op, float* part, int splits,
                   int tiles_per_split, cudaStream_t stream) {
  const unsigned m_tiles = (op.m_max + kTcProductRows - 1) / kTcProductRows;
  const unsigned n_tiles = (op.n_max + kTcTileN - 1) / kTcTileN;
  const dim3 grid(BT ? n_tiles : m_tiles, BT ? m_tiles : n_tiles, splits);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  const size_t bytes = TcSmem<kTcProductRows, 1, AT, BT>::kBytes;
  auto kernel = tc_gemm_kernel<AT, BT>;
  if (int err = set_smem(kernel, bytes)) return err;
  kernel<<<grid, TcShape<kTcProductRows, kTcProductMI>::kThreads, bytes,
           stream>>>(
      op, part, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB,
// 2 = ZIP, 3 = ZINB (NH = 1, 2, 2, 3 heads).  h: bf16 (m, hp); w: bf16
// (hp, NH, fp); b: float32 (NH, f); t: (m_t, f), t_dtype 0 = float32,
// 1 = bfloat16; hp and fp are h's and w's padded widths (multiples of 8 at
// least hidden and f).

// K2: part (ceil(f / 64), m) scratch, out (m,).
int scvae_tc_forward(int family, const void* h, const void* w,
                     const float* b, const void* t, int t_dtype, float* part,
                     float* out, int m, int m_t, int hp, int f,
                     int subtract_const, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return launch_heads<Fam, false>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), b, t,
        t_dtype, nullptr, part, nullptr, m, m_t, hp, f, subtract_const, s);
  });
  if (err) return err;
  return launch_reduce(part, (f + kTcTileN - 1) / kTcTileN, 1, m, m, 1, m,
                       out, 0, 0, s);
}

// K3, first half: da (m, NH * fp) bf16 scratch and db_part
// (ceil(m / 64), NH * fp) float32 scratch, for row cotangents g (m,).
int scvae_tc_gradient(int family, const float* g, const void* h,
                      const void* w, const float* b, const void* t,
                      int t_dtype, void* da, float* db_part, int m, int m_t,
                      int hp, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return launch_heads<Fam, true>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), b, t,
        t_dtype, g, db_part, static_cast<bf16*>(da), m, m_t, hp, f, 0, s);
  });
}

// K3 dh pass, second half: dh (m, hidden) = da w^T over depth k = NH * fp,
// through part (splits, m, hp).
int scvae_tc_dh(const void* da, const void* w, float* part, float* dh, int m,
                int hidden, int hp, int k, int splits, int tiles_per_split,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TcOperands op{static_cast<const bf16*>(da), k, m,
                      static_cast<const bf16*>(w), k, 0, hp, k};
  if (int err = launch_product<false, true>(op, part, splits,
                                            tiles_per_split, s))
    return err;
  return launch_reduce(part, splits, m, hp, hp, m, hidden, dh, 0, hidden, s);
}

// K3 dW/db pass: dw (NH, hidden, f) = h^T da over the m rows, through part
// (splits, hp, NH * fp), and db (NH, f) = the sum of db_part's row tiles.
int scvae_tc_dw(const void* h, const void* da, const float* db_part,
                float* part, float* dw, float* db, int n_heads, int m,
                int hidden, int hp, int f, int splits, int tiles_per_split,
                int row_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fp = (f + 7) / 8 * 8, n = n_heads * fp;
  const TcOperands op{static_cast<const bf16*>(h), hp, hp,
                      static_cast<const bf16*>(da), n, 0, n, m};
  if (int err = launch_product<true, false>(op, part, splits,
                                            tiles_per_split, s))
    return err;
  if (int err = launch_reduce(part, splits, hp, n, fp, hidden, f, dw,
                              (long long)hidden * f, f, s))
    return err;
  return launch_reduce(db_part, row_tiles, 1, n, fp, 1, f, db, f, 0, s);
}

}  // extern "C"
