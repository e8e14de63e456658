// The tensor-core ring of the heads kernels: the forward and gradient
// kernels of the base families (count_likelihood_tc.cu) and of the
// categorised instances (categorised_likelihood_tc.cu), bf16 and float32
// (split into bf16 terms by split_pack_kernel, below), and the pass that
// sums the forwards' row-sum partials in a fixed order.
//
// A block of 64 rows x 64 genes computes the products h W_k of NB heads at
// once: mma.sync m16n8k16 bf16 with float32 accumulators, fed by ldmatrix
// from shared memory that a ring of four stages of 32 hidden units fills
// with cp.async, so the copies of the next stages overlap the products of
// this one and shared memory is bounded by the ring for any H.  The heads
// kernels' float32 epilogue (the transcendentals), not these products, sets
// their time.  The dh and dW products of the backward run on wgmma
// (tc_product.cu).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "count_families.cuh"

namespace scvae {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcDepth = 32;   // depth (hidden units) of one ring stage
constexpr int kTcStages = 4;   // stages of the ring
constexpr int kTcTileN = 64;   // genes of a block: two warps of 32
constexpr int kTcWarpsN = 2;
constexpr int kTcPad = 8;      // bf16 padding per shared row (no bank conflicts)
constexpr int kTcRows = 64;    // rows of a block
constexpr int kTcMI = 2;       // m16 tiles of a warp: 32 x 32 warp tiles
constexpr int kTcWarps = kTcRows / (16 * kTcMI) * kTcWarpsN;
constexpr int kTcThreads = 32 * kTcWarps;

// Shared memory of the ring: per stage the h tile [64][32] and NB weight
// tiles [32][64], each row padded by kTcPad.
template <int NB>
struct TcSmem {
  static constexpr int kA = kTcRows * (kTcDepth + kTcPad);
  static constexpr int kB = kTcDepth * (kTcTileN + kTcPad);
  static constexpr int kStage = kA + NB * kB;  // bf16 elements
  static constexpr size_t kBytes = sizeof(bf16) * kStage * kTcStages;
};

// Shared row stride of the staged activations: 64 columns and a pad that
// keeps the accumulators' float2 stores free of bank conflicts.
constexpr int kTcActStride = kTcTileN + 8;

// Dynamic shared memory of a heads kernel whose groups hold at most NB
// heads: the ring, then (reusing it) the staged activations act[NB][64][72].
template <int NB>
constexpr size_t tc_heads_smem() {
  constexpr size_t ring = TcSmem<NB>::kBytes;
  constexpr size_t acts = sizeof(float) * NB * kTcRows * kTcActStride;
  return ring > acts ? ring : acts;
}

// The operands of the heads' products: h (M, Hp) row-major, and NB weight
// tiles of w (Hp rows, row stride ldw) at columns n0 + hd * head_stride;
// columns from n_max on read as zero (n_max and the strides are multiples
// of 8, so a 16-byte chunk is wholly valid or wholly not).  With depth
// segments (tc_mainloop's SEG > 1), h is (M, SEG Hp) and each segment
// reads its weight tiles from w + w_block times split_first(segment).
struct TcOperands {
  const bf16* h;
  int m;
  int hp;
  const bf16* w;
  long long ldw;
  int head_stride;
  int n_max;
  long long w_block = 0;
};

// The split-bf16 products of float32 operands (the float32 K2/K3 of
// count_likelihood_tc.cu and categorised_likelihood_tc.cu): each float32
// operand x as kSplitTerms bf16 terms, x_0 = bf16(x), x_k = bf16(x - x_0 -
// ... - x_(k-1)), and a product x y as the pairs of terms (x_i, y_j) with
// i + j < kSplitTerms, by i then j (fused_likelihood.SPLIT_TERMS and
// SPLIT_PAIRS).  The first kSplitTerms pairs are (0, j), so pair j <
// kSplitTerms has second term j.
constexpr int kSplitTerms = 3;
constexpr int kSplitPairs = kSplitTerms * (kSplitTerms + 1) / 2;

// The first term i of pair p.
__host__ __device__ constexpr int split_first(int p) {
  int i = 0;
  while (p >= kSplitTerms - i) {
    p -= kSplitTerms - i;
    ++i;
  }
  return i;
}

// The second term j of pair p.
__host__ __device__ constexpr int split_second(int p) {
  return p - (split_first(p) * (2 * kSplitTerms + 1 - split_first(p))) / 2;
}

// x as kSplitTerms bf16 terms: term[k] the bf16 rounding of what the terms
// before it leave, each difference exact in float32.
__device__ __forceinline__ void split_terms(float x,
                                            bf16 (&term)[kSplitTerms]) {
#pragma unroll
  for (int k = 0; k < kSplitTerms; ++k) {
    term[k] = __float2bfloat16_rn(x);
    x -= __bfloat162float(term[k]);
  }
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
template <int R, int C>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld,
                                          int r0, int c0, int r_max,
                                          int c_max) {
  constexpr int kRowChunks = C / 8;
  constexpr int kChunks = R * kRowChunks;
  static_assert(kChunks % kTcThreads == 0, "every thread copies whole chunks");
#pragma unroll
  for (int i = 0; i < kChunks / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    const int r = idx / kRowChunks, c = (idx % kRowChunks) * 8;
    const int gr = r0 + r, gc = c0 + c;
    const bool valid = gr < r_max && gc < c_max;
    const bf16* src = valid ? g + (long long)gr * ld + gc : g;
    cp_async_16(smem_u32(s + r * (C + kTcPad) + c), src, valid);
  }
}

// acc[hd] = h[m0 : m0 + 64, :] W_hd[:, n0 : n0 + 64] through the ring.
// Warp (wm, wn) owns rows wm * 32 + [0, 32) and columns wn * 32 + [0, 32):
// acc[hd][mi][ni] is the m16n8 tile at rows + 16 mi, columns + 8 ni.
// Shared memory is free again on return.  Each mma sums its 16 products
// into zeros and the result is added to acc by a float32 add: an mma aligns
// its products to the largest term, the running sum included, and drops
// the bits below, so a large running sum inside the mma would truncate
// every later product the same way; outside, the sums round to nearest
// like the plain version's float32 product.
//
// SEG > 1 runs the depth over SEG segments of Hp, in order: segment s
// multiplies h's columns [s Hp, (s + 1) Hp) by the weight tiles at
// w + op.w_block * split_first(s).  The split-bf16 float32 kernels lay h's
// terms per pair along h's rows, h_(second term of pair s) in segment s,
// and W's terms per pair in blocks, W_j in block j < kSplitTerms: so acc
// sums h_j W_i over the pairs (i, j), every product of the split.
template <int NB, int SEG = 1>
__device__ __forceinline__ void tc_mainloop(bf16* smem, const TcOperands& op,
                                            int m0, int n0,
                                            float (&acc)[NB][kTcMI][4][4]) {
  using S = TcSmem<NB>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
#pragma unroll
  for (int hd = 0; hd < NB; ++hd)
#pragma unroll
    for (int mi = 0; mi < kTcMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[hd][mi][ni][e] = 0.0f;

  const int n_seg = (op.hp + kTcDepth - 1) / kTcDepth;  // stages a segment
  auto load = [&](int stage, int kt) {
    bf16* sa = smem + stage * S::kStage;
    bf16* sb = sa + S::kA;
    const bf16* h = op.h;
    const bf16* w = op.w;
    int k0 = kt * kTcDepth;
    if constexpr (SEG > 1) {
      const int seg = kt / n_seg;
      h += (long long)seg * op.hp;
      w += op.w_block * split_first(seg);
      k0 = (kt - seg * n_seg) * kTcDepth;
    }
    load_tile<kTcRows, kTcDepth>(sa, h, (long long)SEG * op.hp, m0, k0, op.m,
                                 op.hp);
#pragma unroll
    for (int hd = 0; hd < NB; ++hd)
      load_tile<kTcDepth, kTcTileN>(sb + hd * S::kB, w, op.ldw, k0,
                                    n0 + hd * op.head_stride, op.hp,
                                    op.n_max);
  };

  auto compute = [&](int stage) {
    const bf16* sa = smem + stage * S::kStage;
    const bf16* sb = sa + S::kA;
#pragma unroll
    for (int kk = 0; kk < kTcDepth; kk += 16) {
      uint32_t af[kTcMI][4];
#pragma unroll
      for (int mi = 0; mi < kTcMI; ++mi) {
        const int m = wm * 16 * kTcMI + mi * 16 + (lane & 15);
        const int k = kk + ((lane >> 4) << 3);
        ldsm_x4(af[mi], smem_u32(sa + m * (kTcDepth + kTcPad) + k));
      }
#pragma unroll
      for (int hd = 0; hd < NB; ++hd) {
        const bf16* sbh = sb + hd * S::kB;
        uint32_t bfr[4][2];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int k = kk + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int n = wn * 32 + nj * 16 + ((lane >> 4) << 3);
          uint32_t r[4];
          ldsm_x4_t(r, smem_u32(sbh + k * (kTcTileN + kTcPad) + n));
          bfr[2 * nj][0] = r[0];
          bfr[2 * nj][1] = r[1];
          bfr[2 * nj + 1][0] = r[2];
          bfr[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < kTcMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(part, af[mi], bfr[ni][0], bfr[ni][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[hd][mi][ni][e] += part[e];
          }
      }
    }
  };

  const int n_k = SEG * n_seg;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<kTcStages - 2>();  // stage i has landed
    __syncthreads();                 // and stage i - 1 is read by all
    const int next = i + kTcStages - 1;
    if (next < n_k) load(next % kTcStages, next);
    cp_async_commit();
    compute(i % kTcStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The accumulators into shared memory as act[hd][row][col] (row stride
// kTcActStride), for the epilogue's row-per-warp loop.
template <int NB>
__device__ __forceinline__ void tc_stage_acts(
    float* act, const float (&acc)[NB][kTcMI][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
#pragma unroll
  for (int hd = 0; hd < NB; ++hd)
#pragma unroll
    for (int mi = 0; mi < kTcMI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 16 * kTcMI + mi * 16 + (lane >> 2) + half * 8;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wn * 32 + ni * 8 + 2 * (lane & 3);
          *reinterpret_cast<float2*>(act + (hd * kTcRows + r) * kTcActStride +
                                     c) =
              make_float2(acc[hd][mi][ni][half * 2],
                          acc[hd][mi][ni][half * 2 + 1]);
        }
      }
}

// The block's column sums of da, out[hd * fp + n0 + col] for hd < n_heads
// and genes below fp: each warp's sums col_acc[hd][j] (columns lane + 32 j
// of its rows) through shared memory red[warp][hd][64], then the warps in
// order.  Starts and ends with __syncthreads, so red may overlap act.
template <int NB>
__device__ __forceinline__ void tc_store_col_sums(
    float* red, const float (&col_acc)[NB][2], float* out, int n0, int fp,
    int n_heads) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // every warp is done reading act
#pragma unroll
  for (int hd = 0; hd < NB; ++hd)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      red[(warp * NB + hd) * kTcTileN + lane + 32 * j] = col_acc[hd][j];
  __syncthreads();
  for (int c = threadIdx.x; c < NB * kTcTileN; c += kTcThreads) {
    const int hd = c / kTcTileN, cl = c % kTcTileN;
    const int gene = n0 + cl;
    if (hd < n_heads && gene < fp) {
      float s = 0.0f;
      for (int j = 0; j < kTcWarps; ++j) s += red[(j * NB + hd) * kTcTileN + cl];
      out[hd * fp + gene] = s;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float load_t(const void* t, int t_bf16,
                                        long long i) {
  return t_bf16 ? __bfloat162float(static_cast<const bf16*>(t)[i])
                : static_cast<const float*>(t)[i];
}

constexpr int kTcReduceThreads = 256;

// out[c] = sum over s < n_slices, in order, of part[s][c] (an n_slices x n
// array).
__global__ void __launch_bounds__(kTcReduceThreads)
    reduce_kernel(const float* __restrict__ part, int n_slices, int n,
                  float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < n_slices; ++j) s += part[j * (long long)n + i];
    out[i] = s;
  }
}

// The heads forwards' second pass: out (n,) from their (gene tiles, n)
// row-sum partials, at most 16 blocks per SM.
int launch_reduce(const float* part, int n_slices, int n, float* out,
                  cudaStream_t stream) {
  if (n == 0) return 0;
  const int blocks = (n + kTcReduceThreads - 1) / kTcReduceThreads;
  reduce_kernel<<<blocks < 132 * 16 ? blocks : 132 * 16, kTcReduceThreads, 0,
                  stream>>>(part, n_slices, n, out);
  return (int)cudaGetLastError();
}

constexpr int kPackThreads = 256;
constexpr int kPackCols = 8;  // columns of a thread: one 16-byte store a pair

// The float32 kernels' operands in their pair layouts: for each of the
// n_src float32 matrices src_k (rows x cols, row-major; src_k = s0 + k
// stride for a stride > 0, else s0, s1, s2),
//   dst[r ld_row + p ld_pair + k ld_src + c] = term j of src_k[r][c]
// for each pair p = (i, j), zero where r >= rows or c >= cols, over
// rows_p x cols_p (the padded widths, cols_p and the strides multiples of
// 8).  A thread per 8 columns of a row: its float32 reads coalesce along
// the row, and it stores each pair's 8 terms as one 16-byte write.  Its
// plain version is fused_likelihood._f32_tc_operands.
__global__ void __launch_bounds__(kPackThreads)
    split_pack_kernel(const float* __restrict__ s0,
                      const float* __restrict__ s1,
                      const float* __restrict__ s2, long long stride,
                      int n_src, int rows, int cols, int rows_p, int cols_p,
                      bf16* __restrict__ dst, long long ld_row,
                      long long ld_pair, long long ld_src) {
  const int chunks = cols_p / kPackCols;
  const long long per = (long long)rows_p * chunks;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < per * n_src; e += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(e / per);
    const long long rc = e - k * per;
    const int r = (int)(rc / chunks);
    const int c0 = (int)(rc - (long long)r * chunks) * kPackCols;
    const float* src =
        (stride > 0 ? s0 + k * stride : (k == 0 ? s0 : (k == 1 ? s1 : s2)))
        + (long long)r * cols;
    uint32_t words[kSplitPairs][kPackCols / 2];  // two bf16 terms each
#pragma unroll
    for (int q = 0; q < kPackCols; ++q) {
      const int c = c0 + q;
      bf16 term[kSplitTerms];
      split_terms(r < rows && c < cols ? src[c] : 0.0f, term);
#pragma unroll
      for (int p = 0; p < kSplitPairs; ++p) {
        const uint32_t bits = __bfloat16_as_ushort(term[split_second(p)]);
        if (q % 2 == 0)
          words[p][q / 2] = bits;
        else
          words[p][q / 2] |= bits << 16;
      }
    }
    bf16* base = dst + r * ld_row + k * ld_src + c0;
#pragma unroll
    for (int p = 0; p < kSplitPairs; ++p)
      *reinterpret_cast<uint4*>(base + p * ld_pair) =
          make_uint4(words[p][0], words[p][1], words[p][2], words[p][3]);
  }
}

// h (m, hidden) into its terms per pair (m, P, hp), and the heads' W
// (hidden, f) into theirs (hp, P, NH, fp), NH = n_base + n_classes: the
// n_base base heads w0, w1, w2 (null past n_base), then the classes of
// the class-major cat_w (n_classes, hidden, f).
int launch_split_operands(int n_base, const float* h, const float* w0,
                          const float* w1, const float* w2,
                          const float* cat_w, int n_classes, bf16* hh,
                          bf16* wp, int m, int hidden, int hp, int f, int fp,
                          cudaStream_t stream) {
  auto launch = [&](const float* s0, const float* s1, const float* s2,
                    long long stride, int n_src, int rows, int cols,
                    int rows_p, int cols_p, bf16* dst, long long ld_row,
                    long long ld_pair, long long ld_src) {
    const long long n = (long long)rows_p * (cols_p / kPackCols) * n_src;
    if (n == 0) return 0;
    const long long blocks = (n + kPackThreads - 1) / kPackThreads;
    split_pack_kernel<<<blocks < 132 * 16 ? blocks : 132 * 16, kPackThreads,
                        0, stream>>>(s0, s1, s2, stride, n_src, rows, cols,
                                     rows_p, cols_p, dst, ld_row, ld_pair,
                                     ld_src);
    return (int)cudaGetLastError();
  };
  if (int err = launch(h, h, h, 0, 1, m, hidden, m, hp, hh,
                       (long long)kSplitPairs * hp, hp, 0))
    return err;
  const long long width = (long long)(n_base + n_classes) * fp;
  if (int err = launch(w0, w1, w2, 0, n_base, hidden, f, hp, fp, wp,
                       kSplitPairs * width, width, fp))
    return err;
  return launch(cat_w, cat_w, cat_w, (long long)hidden * f, n_classes,
                hidden, f, hp, fp, wp + (long long)n_base * fp,
                kSplitPairs * width, width, fp);
}

}  // namespace
}  // namespace scvae
