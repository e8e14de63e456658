// K5 with bf16 operands on the tensor cores: the grouped backward's
// gradient kernel for the Poisson, NB, ZIP and ZINB families.
//
// Replaces, for bf16 inputs, the Pallas kernel of
// scvae_tpu/ops/fused_likelihood.py _make_grouped_backward_kernel driven by
// _grouped_backward (K5).  The float32 instance keeps the CUDA-core passes
// of grouped_likelihood.cu.  G groups of decoder output h (G, M, H) - the
// GMVAE's K·S cluster-sample groups - share one block of targets t (M, F);
// with row cotangents g (G, M) and the family's heads W_k (H, F), b_k (F,):
//
//   a_k  = bf16(h_g) bf16(W_k) + b_k     (float32 sums, b_k unrounded)
//   da_k = g[g, i] * dll/da_k            (float32; zero outside each clip range)
//   dh_g = sum_k bf16(da_k) W_k^T,  dW_k = sum_g h_g^T bf16(da_k),
//   db_k = sum_g sum_rows da_k           (unrounded)
//
// Operands arrive from the wrapper as the flat tensor-core kernels take
// them (count_likelihood_tc.cu): h (G·M, Hp) group-major, W (Hp, NH, Fp),
// both bf16 and zero-padded to multiples of 8.  This kernel writes bf16(da)
// into the flat kernels' scratch layout (G·M, NH·Fp), rows group-major, and
// the unrounded column sums over all groups per 64 target rows,
// db_part (ceil(M / 64), NH·Fp); the dh and dW products of tc_product.cu
// then read them over the G·M rows unchanged.
//
// What the group loop buys: a block owns 128 target rows x 64 genes for
// every group.  It reads the block's (128 x 64) t tile and biases once into
// shared memory, and keeps every head's (Hp x 64) W tile resident in shared
// memory for the whole group loop (in depth chunks of w_chunk rows when
// they do not fit, restaged per group, as the flat kernels restage W for
// every row tile).  Only h_g streams: its (128 x 32) slices run through a
// four-stage cp.async ring over the flattened (group, depth) sequence, so
// group g + 1's first slices are in flight while group g's epilogue runs.
// Sixteen warps of 16 rows x 32 genes each take mma.sync m16n8k16 on
// ldmatrix fragments (the products of tc_common.cuh), and the epilogue
// works on the accumulators in registers: each thread holds the same 16
// (row, gene) elements of every group, so its t and bias come from shared
// memory and its column sums of da stay in registers across the groups,
// reduced once at the end in a fixed order.  No atomics: results repeat
// bit for bit.
//
// Shared memory at Hp = 256: W 36.9 KB per head (NB 73.7, ZINB 110.6), the
// ring 40 KB, t 36 KB: one block per SM for every family, whose sixteen
// warps (the flat kernel's count for one or two heads) keep the epilogue's
// transcendentals busy; 16-row warp tiles keep its accumulators within the
// 128 registers that sixteen warps leave each thread.
//
// Bound on the H100 at the GMVAE's shape (G = 10, M = F = 2048, H = 256):
// the function's bytes - h (G·M·H) and W, b in float32 once, t (M, F) once,
// g, bf16(da) (G·M·NH·F) written once - against 2·NH·G·M·H·F operations of
// the heads' products; NB: 82 MB at 3.35 TB/s (0.024 ms) against 21.5 GFLOP
// (0.022 ms).  The epilogue's float32 transcendentals, as in the flat
// gradient kernel, set its time.

#include "tc_common.cuh"

namespace scvae {
namespace {

constexpr int kGtMI = 1;                        // m16 tiles of a warp
constexpr int kGtWarpRows = 16 * kGtMI;         // rows of a warp
constexpr int kGtWarpsM = 8;
constexpr int kGtRows = kGtWarpRows * kGtWarpsM;  // target rows of a block
constexpr int kGtWarps = kGtWarpsM * kTcWarpsN;
constexpr int kGtThreads = 32 * kGtWarps;
constexpr int kGtStages = 4;                    // h slices in flight
constexpr int kGtHStride = kTcDepth + kTcPad;   // bf16 row stride of a slice
constexpr int kGtWStride = kTcTileN + kTcPad;   // bf16 row stride of W
constexpr int kGtTStride = kTcTileN + 8;        // float row stride of t
constexpr int kGtRowTile = 64;                  // rows of a db_part row
constexpr size_t kGtSmemMax = 232448;           // a block's shared memory

// Dynamic shared memory of the kernel with NH heads and W chunks of
// w_chunk rows: W [NH][w_chunk][72] bf16, the ring [4][128][40] bf16, t
// [128][72] float and the biases [NH][64] float.  The column sums' last
// reduction, red [8][NH][64] float, reuses the ring.
__host__ __device__ constexpr size_t gt_w_bytes(int n_heads, int w_chunk) {
  return sizeof(bf16) * (size_t)n_heads * w_chunk * kGtWStride;
}
constexpr size_t kGtRingBytes =
    sizeof(bf16) * kGtStages * kGtRows * kGtHStride;
constexpr size_t kGtTBytes = sizeof(float) * kGtRows * kGtTStride;
__host__ __device__ constexpr size_t gt_smem_bytes(int n_heads, int w_chunk) {
  return gt_w_bytes(n_heads, w_chunk) + kGtRingBytes + kGtTBytes +
         sizeof(float) * n_heads * kTcTileN;
}

template <class Fam>
__global__ void __launch_bounds__(kGtThreads, 1)
    grouped_tc_gradient_kernel(const float* __restrict__ g,
                               const bf16* __restrict__ h,
                               const bf16* __restrict__ w,
                               const float* __restrict__ bias,
                               const void* __restrict__ t, int t_bf16,
                               bf16* __restrict__ da,
                               float* __restrict__ db_part, int n_groups,
                               int m, int hp, int f, int fp, int w_chunk) {
  constexpr int NH = Fam::kHeads;
  extern __shared__ __align__(16) unsigned char gt_smem_raw[];
  bf16* sw = reinterpret_cast<bf16*>(gt_smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(gt_smem_raw +
                                       gt_w_bytes(NH, w_chunk));
  float* st = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ring) +
                                       kGtRingBytes);
  float* sb = st + kGtRows * kGtTStride;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
  const int m0 = blockIdx.x * kGtRows, n0 = blockIdx.y * kTcTileN;
  const int ldd = NH * fp;
  const int n_k = (hp + kTcDepth - 1) / kTcDepth;  // depth slices of h
  const int chunk_k = w_chunk / kTcDepth;          // slices of a W chunk
  const int n_chunks = (n_k + chunk_k - 1) / chunk_k;
  const int total = n_groups * n_k;

  // W rows [c * w_chunk, +w_chunk) of every head at genes n0 + [0, 64),
  // zero past Hp and Fp.
  auto load_w = [&](int c) {
    const int k0 = c * w_chunk, per_head = w_chunk * (kTcTileN / 8);
    for (int i = tid; i < NH * per_head; i += kGtThreads) {
      const int hd = i / per_head, rem = i % per_head;
      const int r = rem / (kTcTileN / 8), cc = (rem % (kTcTileN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + cc;
      const bool valid = gk < hp && gn < fp;
      const bf16* src = valid ? w + (long long)gk * ldd + hd * fp + gn : w;
      cp_async_16(smem_u32(sw + (hd * w_chunk + r) * kGtWStride + cc), src,
                  valid);
    }
  };
  // Slice i of the (group, depth) sequence: h_g rows m0 + [0, 128), hidden
  // units 32 kt + [0, 32), zero past M and Hp.
  auto load_h = [&](int stage, int i) {
    const int gi = i / n_k, k0 = (i % n_k) * kTcDepth;
    const bf16* hg = h + (long long)gi * m * hp;
    bf16* s = ring + stage * kGtRows * kGtHStride;
    for (int j = tid; j < kGtRows * (kTcDepth / 8); j += kGtThreads) {
      const int r = j / (kTcDepth / 8), cc = (j % (kTcDepth / 8)) * 8;
      const int row = m0 + r, k = k0 + cc;
      const bool valid = row < m && k < hp;
      const bf16* src = valid ? hg + (long long)row * hp + k : h;
      cp_async_16(smem_u32(s + r * kGtHStride + cc), src, valid);
    }
  };

  load_w(0);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kGtStages - 1; ++s) {
    if (s < total) load_h(s, s);
    cp_async_commit();
  }
  // the t tile and the biases, once for every group
  for (int i = tid; i < kGtRows * kTcTileN; i += kGtThreads) {
    const int r = i / kTcTileN, c = i % kTcTileN;
    const int row = m0 + r, gene = n0 + c;
    st[r * kGtTStride + c] =
        row < m && gene < f ? load_t(t, t_bf16, (long long)row * f + gene)
                            : 0.0f;
  }
  for (int i = tid; i < NH * kTcTileN; i += kGtThreads) {
    const int gene = n0 + i % kTcTileN;
    sb[i] = gene < f ? bias[(i / kTcTileN) * f + gene] : 0.0f;
  }

  // this thread's elements: rows wm * 16 kGtMI + 16 mi + (lane >> 2) +
  // 8 half, genes wn * 32 + 8 ni + 2 (lane & 3) + e
  float col[NH][4][2];
#pragma unroll
  for (int hd = 0; hd < NH; ++hd)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) col[hd][ni][0] = col[hd][ni][1] = 0.0f;
  float acc[NH][kGtMI][4][4];

  for (int gi = 0; gi < n_groups; ++gi) {
#pragma unroll
    for (int hd = 0; hd < NH; ++hd)
#pragma unroll
      for (int mi = 0; mi < kGtMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[hd][mi][ni][e] = 0.0f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int i = gi * n_k + kt;
      if (n_chunks > 1 && kt % chunk_k == 0 && i > 0) {
        __syncthreads();  // every warp is done with the previous chunk
        load_w(kt / chunk_k);
        cp_async_commit();
        cp_async_wait<0>();
      }
      cp_async_wait<kGtStages - 2>();  // slice i (and W) has landed
      __syncthreads();                 // and slice i - 1 is read by all
      const int next = i + kGtStages - 1;
      if (next < total) load_h(next % kGtStages, next);
      cp_async_commit();

      const bf16* sa = ring + (i % kGtStages) * kGtRows * kGtHStride;
      const int kw = (kt % chunk_k) * kTcDepth;
#pragma unroll
      for (int kk = 0; kk < kTcDepth; kk += 16) {
        uint32_t af[kGtMI][4];
#pragma unroll
        for (int mi = 0; mi < kGtMI; ++mi) {
          const int r = wm * kGtWarpRows + mi * 16 + (lane & 15);
          const int k = kk + ((lane >> 4) << 3);
          ldsm_x4(af[mi], smem_u32(sa + r * kGtHStride + k));
        }
#pragma unroll
        for (int hd = 0; hd < NH; ++hd) {
          const bf16* swh = sw + hd * w_chunk * kGtWStride;
          uint32_t bfr[4][2];
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            const int k = kw + kk + (lane & 7) + (((lane >> 3) & 1) << 3);
            const int n = wn * 32 + nj * 16 + ((lane >> 4) << 3);
            uint32_t r4[4];
            ldsm_x4_t(r4, smem_u32(swh + k * kGtWStride + n));
            bfr[2 * nj][0] = r4[0];
            bfr[2 * nj][1] = r4[1];
            bfr[2 * nj + 1][0] = r4[2];
            bfr[2 * nj + 1][1] = r4[3];
          }
          // each mma sums its 16 products into zeros, then a float32 add
          // (tc_mainloop's reason: a running sum inside the mma truncates)
#pragma unroll
          for (int mi = 0; mi < kGtMI; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_bf16(part, af[mi], bfr[ni][0], bfr[ni][1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[hd][mi][ni][e] += part[e];
            }
        }
      }
    }

    // epilogue of group gi, from the accumulators: da_k = g dll/da_k
    const long long grow0 = (long long)gi * m;
#pragma unroll
    for (int mi = 0; mi < kGtMI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * kGtWarpRows + mi * 16 + (lane >> 2) + half * 8;
        const int row = m0 + r;
        const bool row_ok = row < m;
        const float grow = row_ok ? g[grow0 + row] : 0.0f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wn * 32 + ni * 8 + 2 * (lane & 3);
          const int gene = n0 + c;
          const float2 tv =
              *reinterpret_cast<const float2*>(st + r * kGtTStride + c);
          float gr[2][NH];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float a[NH];
#pragma unroll
            for (int hd = 0; hd < NH; ++hd) {
              a[hd] = acc[hd][mi][ni][half * 2 + e] +
                      sb[hd * kTcTileN + c + e];
              gr[e][hd] = 0.0f;
            }
            if (row_ok && gene + e < f) {
              Fam::grads(a, e ? tv.y : tv.x, nullptr, gr[e]);
#pragma unroll
              for (int hd = 0; hd < NH; ++hd) gr[e][hd] *= grow;
            }
#pragma unroll
            for (int hd = 0; hd < NH; ++hd) col[hd][ni][e] += gr[e][hd];
          }
          if (row_ok && gene < fp) {
            bf16* out = da + (grow0 + row) * ldd + gene;
#pragma unroll
            for (int hd = 0; hd < NH; ++hd)
              *reinterpret_cast<__nv_bfloat162*>(out + hd * fp) =
                  __floats2bfloat162_rn(gr[0][hd], gr[1][hd]);
          }
        }
      }
  }

  // the column sums: over the eight lanes of a column, then the four warps
  // of each 64 target rows, in order; the ring is free again
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [warp rows][NH][64]
#pragma unroll
  for (int hd = 0; hd < NH; ++hd)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = col[hd][ni][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < 4)
          red[(wm * NH + hd) * kTcTileN + wn * 32 + ni * 8 + 2 * lane + e] = v;
      }
  __syncthreads();
  constexpr int kTiles = kGtRows / kGtRowTile;
  constexpr int kWarpRowsPerTile = kGtRowTile / kGtWarpRows;
  const int row_tiles = (m + kGtRowTile - 1) / kGtRowTile;
  for (int i = tid; i < kTiles * NH * kTcTileN; i += kGtThreads) {
    const int s = i / (NH * kTcTileN), rem = i % (NH * kTcTileN);
    const int hd = rem / kTcTileN, c = rem % kTcTileN;
    const int tile = m0 / kGtRowTile + s, gene = n0 + c;
    if (tile < row_tiles && gene < fp) {
      float v = 0.0f;
      for (int j = 0; j < kWarpRowsPerTile; ++j)
        v += red[((s * kWarpRowsPerTile + j) * NH + hd) * kTcTileN + c];
      db_part[(long long)tile * ldd + hd * fp + gene] = v;
    }
  }
}

template <class Fam>
int launch_grouped_gradient(const float* g, const bf16* h, const bf16* w,
                            const float* b, const void* t, int t_bf16,
                            bf16* da, float* db_part, int n_groups, int m,
                            int hp, int f, int w_chunk, cudaStream_t stream) {
  const dim3 grid((m + kGtRows - 1) / kGtRows,
                  (f + kTcTileN - 1) / kTcTileN);
  if (grid.x == 0 || grid.y == 0 || n_groups == 0) return 0;
  const size_t bytes = gt_smem_bytes(Fam::kHeads, w_chunk);
  if (w_chunk < kTcDepth || w_chunk % kTcDepth || bytes > kGtSmemMax)
    return (int)cudaErrorInvalidValue;
  auto kernel = grouped_tc_gradient_kernel<Fam>;
  if (int err = set_smem(kernel, bytes)) return err;
  const int fp = (f + 7) / 8 * 8;
  kernel<<<grid, kGtThreads, bytes, stream>>>(g, h, w, b, t, t_bf16, da,
                                              db_part, n_groups, m, hp, f,
                                              fp, w_chunk);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// Returns a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB,
// 2 = ZIP, 3 = ZINB (NH = 1, 2, 2, 3 heads).  g: float32 (n_groups, m);
// h: bf16 (n_groups * m, hp); w: bf16 (hp, NH, fp); b: float32 (NH, f);
// t: (m, f), t_dtype 0 = float32, 1 = bfloat16; da: bf16
// (n_groups * m, NH * fp); db_part: float32 (ceil(m / 64), NH * fp);
// w_chunk: rows of W resident at once, a multiple of 32
// (ops/fused_likelihood.py grouped_tc_plan).
int scvae_grouped_tc_gradient(int family, const float* g, const void* h,
                              const void* w, const float* b, const void* t,
                              int t_dtype, void* da, float* db_part,
                              int n_groups, int m, int hp, int f, int w_chunk,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return launch_grouped_gradient<Fam>(
        g, static_cast<const bf16*>(h), static_cast<const bf16*>(w), b, t,
        t_dtype, static_cast<bf16*>(da), db_part, n_groups, m, hp, f,
        w_chunk, s);
  });
}

}  // extern "C"
