// K4 and K5 on the tensor cores: the grouped fused likelihood, forward and
// backward, of the Poisson, NB, ZIP and ZINB families, bf16 and float32.
//
// Replaces the Pallas kernels of scvae_tpu/ops/fused_likelihood.py
// _make_grouped_forward_kernel driven by _grouped_forward (K4) and
// _make_grouped_backward_kernel driven by _grouped_backward (K5).  G groups
// of decoder output h (G, M, H) - the GMVAE's K·S cluster-sample groups -
// share one block of targets t (M, F); with row cotangents g (G, M) and the
// family's heads W_k (H, F), b_k (F,), for bf16:
//
//   a_k  = bf16(h_g) bf16(W_k) + b_k     (float32 sums, b_k unrounded)
//   ll[g, i] = sum_f log p(t_i | a) - lgamma(1 + t_i)    (always subtracted)
//   da_k = g[g, i] * dll/da_k            (float32; zero outside each clip range)
//   dh_g = sum_k bf16(da_k) W_k^T,  dW_k = sum_g h_g^T bf16(da_k),
//   db_k = sum_g sum_rows da_k           (unrounded)
//
// and for float32 (SEG = kSplitPairs) the split design of the flat float32
// kernels (count_likelihood_tc.cu): h, W and da as three bf16 terms, a_k
// summed over the six pairs (i, j) of h_j W_k,i in their order, da's term i
// of pair p in slot p of the scratch.
//
// grouped_tc_heads_kernel<Fam, DH, SEG> is the forward (DH = false) and the
// backward's gradient kernel (DH = true): one ring, one pair order, the same
// packed operands, so the gradient kernel sums the very same a as the
// forward.  Operands, bf16 as the flat kernels take them (_tc_operands):
// h (G·M, Hp) group-major and W (Hp, NH, Fp); float32 as split_pack_kernel
// packs them for the flat float32 kernels: h (G·M, P, Hp), W (Hp, P, NH,
// Fp).  The forward writes the row sums of ll over each 64-gene tile,
// part (gene tiles, G·M), which reduce_kernel sums in order.  The gradient
// kernel writes da into the flat kernels' scratch layout, (G·M, NH·Fp) or
// (G·M, P·NH·Fp), rows group-major, and the unrounded column sums over all
// groups per 64 target rows, db_part (ceil(M / 64), NH·Fp); the dh and dW
// products of tc_product.cu then read them over the G·M rows, float32 as
// f32_tc_plan plans the flat float32 backward's.
//
// What the group loop buys: a block owns 128 target rows x 64 genes for
// every group.  It reads the block's (128 x 64) t tile and biases once into
// shared memory and keeps every head's (Hp x 64) W tile resident in shared
// memory over the group loop.  Only h_g streams: its (128 x 64) slices run
// through a four-stage cp.async ring over the flattened (group, segment,
// depth) sequence, so group g + 1's first slices are in flight while group
// g's epilogue runs; the ring's position is kept in counters, not divided
// out per slice.  Sixteen warps of 16 rows x 32 genes take mma.sync
// m16n8k16 on ldmatrix fragments (tc_common.cuh), and the epilogue works
// on the accumulators in registers: each thread holds the same (row, gene)
// elements of every group, so its t and bias come from shared memory, the
// forward sums its lgamma(1 + t) once per block, and the gradient kernel
// adds each group's column sums of da to its warp's sums in shared memory,
// reduced once at the end in a fixed order.  The float32 gradient kernel
// stores da's terms through a transpose across a row's four lanes, 16
// bytes a lane (the mma layout leaves each lane 4 bytes of a row).  No
// atomics: results repeat bit for bit.  Measured on the H100 (PERF.md §6):
// eight warps of 32 rows were slower in 6 of 8 forwards, 32-deep slices
// slower than 64 in every float32 kernel.
//
// W in shared memory: `slots` slots of w_rows rows, [NH][w_rows][72] bf16
// each.  Where every term of W fits (bf16 at Hp = 256 for every family;
// float32 Poisson's three terms), it is loaded once.  Otherwise a slot is
// restaged when the ring reaches a (term, depth chunk) that it does not
// hold: float32 NB, ZIP and ZINB (three terms of 73.7 to 110.6 KB at Hp =
// 256 against the 115 to 117 KB the ring, the t tile and the sums leave)
// keep one slot and restage each term as the ring reaches it, three times
// a group; a term deeper than a slot (bf16 NB past Hp = 384) is restaged
// chunk by chunk, as the flat kernels restage W for every row tile.
// ops/fused_likelihood.py grouped_tc_plan plans it.
//
// Shared memory at Hp = 256: W 36.9 KB a term per head, the ring 72 KB,
// t 36 KB, the biases and the sums 6.8 KB at most: one block per SM for
// every family and dtype.  16-row warp tiles keep the accumulators within
// the 128 registers that sixteen warps leave a thread.
//
// Bound on the H100 at the GMVAE's shape (G = 10, M = F = 2048, H = 256):
// the function's bytes - h (G·M·H) and W, b in float32 once, t (M, F) once,
// g, and da (G·M·NH·F; bf16 for bf16, float32 for float32) or the row sums
// written once - against 2·NH·G·M·H·F operations of the heads' products,
// counted once however many pairs the float32 design multiplies; NB's
// gradient kernel: 82 MB at 3.35 TB/s (0.024 ms) against 21.5 GFLOP
// (0.022 ms).  The epilogue's float32 transcendentals, as in the flat
// kernels, set the time; float32 adds six times the products and writes
// six bf16 terms of da a value.

#include "tc_common.cuh"

namespace scvae {
namespace {

constexpr int kGtRows = 128;                    // target rows of a block
constexpr int kGtWarpsM = kGtRows / 16;         // warps of 16 rows
constexpr int kGtThreads = 32 * kGtWarpsM * kTcWarpsN;
constexpr int kGtStages = 4;                    // h slices in flight
constexpr int kGtDepth = 64;                    // hidden units of a slice
constexpr int kGtHStride = kGtDepth + kTcPad;   // bf16 row stride of a slice
constexpr int kGtWStride = kTcTileN + kTcPad;   // bf16 row stride of W
constexpr int kGtTStride = kTcTileN + 8;        // float row stride of t
constexpr int kGtRowTile = 64;                  // rows of a db_part row
constexpr size_t kGtSmemMax = 232448;           // a block's shared memory

// Dynamic shared memory of the kernel with NH heads and `slots` W slots of
// w_rows rows: W [slots][NH][w_rows][72] bf16, the ring [4][128][72] bf16, t [128][72] float, the biases [NH][64] float and
// the sums [8][NH][64] float: the gradient kernel's column sums of each
// warp's rows, or the forward's row sums [2][128] of a group.
constexpr size_t kGtRingBytes =
    sizeof(bf16) * kGtStages * kGtRows * kGtHStride;
constexpr size_t kGtTBytes = sizeof(float) * kGtRows * kGtTStride;
__host__ __device__ constexpr size_t gt_sum_bytes(int n_heads) {
  return sizeof(float) * kGtWarpsM * n_heads * kTcTileN;
}
__host__ __device__ constexpr size_t gt_w_bytes(int n_heads, int w_rows,
                                                int slots) {
  return sizeof(bf16) * (size_t)slots * n_heads * w_rows * kGtWStride;
}
__host__ __device__ constexpr size_t gt_smem_bytes(int n_heads, int w_rows,
                                                   int slots) {
  return gt_w_bytes(n_heads, w_rows, slots) + kGtRingBytes + kGtTBytes +
         sizeof(float) * n_heads * kTcTileN + gt_sum_bytes(n_heads);
}

// A row's 32 genes held by its four lanes as w[ni], the bf16 pair of genes
// 8 ni + 2 (lane & 3) + {0, 1}, returned as lane q's 8 consecutive genes
// 8 q + [0, 8): a 4 x 4 transpose across the lanes, so that the row's 64
// bytes go out as four 16-byte stores.
__device__ __forceinline__ uint4 transpose_row(const uint32_t (&w)[4]) {
  const int lane = threadIdx.x % 32, l = lane & 3;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // lane l sends w[l + k] and takes from lane l - k its w[l] (mod 4)
    const int si = (l + k) & 3, src = (l - k) & 3;
    uint32_t v = si == 0 ? w[0] : si == 1 ? w[1] : si == 2 ? w[2] : w[3];
    v = __shfl_sync(0xffffffffu, v, (lane & ~3) | src);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = src == j ? v : out[j];
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint32_t bf16_pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

struct GtArgs {
  const float* g;      // (G·M,) row cotangents (gradient kernel)
  const bf16* h;       // (G·M, SEG, Hp)
  const bf16* w;       // (Hp, SEG, NH, Fp)
  const float* bias;   // (NH, F)
  const void* t;       // (M, F), float32 or (t_bf16) bf16
  int t_bf16;
  bf16* da;            // (G·M, SEG, NH, Fp) (gradient kernel)
  float* part;         // forward (gene tiles, G·M); gradient (ceil(M / 64), NH·Fp)
  int n_groups, m, hp, f, fp;
  int w_rows, slots;
};

// DH = false (K4): part[blockIdx.y][g M + row] = the block's sum over its
// genes of ll - lgamma(1 + t).  DH = true (K5's first kernel):
// da[g M + row][(p NH + hd) Fp + gene] = the term split_first(p) of g[g M
// + row] dll/da_hd (bf16(.) for SEG = 1), zero past F, and
// part[tile][hd Fp + gene] = the sum over every group of the unrounded
// values of the 64 target rows of the tile.
template <class Fam, bool DH, int SEG>
__global__ void __launch_bounds__(kGtThreads, 1)
    grouped_tc_heads_kernel(const GtArgs p) {
  constexpr int NH = Fam::kHeads;
  constexpr int kChunks = kGtRows * kGtDepth / 8 / kGtThreads;  // copies
  extern __shared__ __align__(16) unsigned char gt_smem_raw[];
  bf16* sw = reinterpret_cast<bf16*>(gt_smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(gt_smem_raw +
                                       gt_w_bytes(NH, p.w_rows, p.slots));
  float* st = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ring) +
                                       kGtRingBytes);
  float* sb = st + kGtRows * kGtTStride;
  float* sums = sb + NH * kTcTileN;  // column sums, or a group's row sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
  const int m0 = blockIdx.x * kGtRows, n0 = blockIdx.y * kTcTileN;
  const int width = NH * p.fp;                   // one pair's columns
  const long long ldw = (long long)SEG * width;  // row stride of W and da
  const long long ldh = (long long)SEG * p.hp;   // row stride of h
  const int n_seg = (p.hp + kGtDepth - 1) / kGtDepth;  // slices a segment
  const int chunk_k = p.w_rows / kGtDepth;             // slices a slot
  const int n_dc = (n_seg + chunk_k - 1) / chunk_k;  // chunks a term
  const int slot_size = NH * p.w_rows * kGtWStride;

  // W's term `term`, rows dc * w_rows + [0, w_rows), of every head at
  // genes n0 + [0, 64) into slot `slot`, zero past Hp and Fp (the bound at
  // Fp keeps a ragged last gene tile out of the next pair's block).
  auto load_w = [&](int slot, int term, int dc) {
    const int k0 = dc * p.w_rows, per_head = p.w_rows * (kTcTileN / 8);
    const bf16* wt = p.w + (long long)term * width;
    bf16* dst = sw + slot * slot_size;
    for (int i = tid; i < NH * per_head; i += kGtThreads) {
      const int hd = i / per_head, rem = i % per_head;
      const int r = rem / (kTcTileN / 8), cc = (rem % (kTcTileN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + cc;
      const bool valid = gk < p.hp && gn < p.fp;
      const bf16* src = valid ? wt + gk * ldw + hd * p.fp + gn : p.w;
      cp_async_16(smem_u32(dst + (hd * p.w_rows + r) * kGtWStride + cc), src,
                  valid);
    }
  };
  // The ring's next slice, at group lg, segment lseg, depth slice lk: h_g
  // rows m0 + [0, 128), hidden units 64 lk + [0, 64) of the segment, zero
  // past M and Hp; then the position moves on by one slice.
  int lg = 0, lseg = 0, lk = 0;
  auto load_h = [&](int stage) {
    if (lg < p.n_groups) {
      bf16* s = ring + stage * kGtRows * kGtHStride;
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        const int j = tid + u * kGtThreads;
        const int r = j / (kGtDepth / 8), cc = (j % (kGtDepth / 8)) * 8;
        const int row = m0 + r, k = lk * kGtDepth + cc;
        const bool valid = row < p.m && k < p.hp;
        const bf16* src =
            valid ? p.h + (long long)(lg * p.m + row) * ldh +
                        (long long)lseg * p.hp + k
                  : p.h;
        cp_async_16(smem_u32(s + r * kGtHStride + cc), src, valid);
      }
    }
    cp_async_commit();
    if (++lk == n_seg) {
      lk = 0;
      if (++lseg == SEG) {
        lseg = 0;
        ++lg;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kGtStages - 1; ++s) load_h(s);
  // the t tile and the biases, once for every group
  for (int i = tid; i < kGtRows * kTcTileN; i += kGtThreads) {
    const int r = i / kTcTileN, c = i % kTcTileN;
    const int row = m0 + r, gene = n0 + c;
    st[r * kGtTStride + c] =
        row < p.m && gene < p.f
            ? load_t(p.t, p.t_bf16, (long long)row * p.f + gene)
            : 0.0f;
  }
  for (int i = tid; i < NH * kTcTileN; i += kGtThreads) {
    const int gene = n0 + i % kTcTileN;
    sb[i] = gene < p.f ? p.bias[(i / kTcTileN) * p.f + gene] : 0.0f;
  }

  // this thread's elements: rows wm * 16 + (lane >> 2) + 8 half, genes
  // wn * 32 + 8 ni + 2 (lane & 3) + e
  float lg_t[2];  // the forward's sums of lgamma(1 + t)
  if constexpr (DH) {
    for (int i = tid; i < kGtWarpsM * NH * kTcTileN; i += kGtThreads)
      sums[i] = 0.0f;
  } else {
    __syncthreads();  // the t tile is staged
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + (lane >> 2) + half * 8;
      float s = 0.0f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * 32 + ni * 8 + 2 * (lane & 3) + e;
          if (m0 + r < p.m && n0 + c < p.f)
            s += series_lgamma(1.0f + st[r * kGtTStride + c]);
        }
      lg_t[half] = s;
    }
  }

  float acc[NH][4][4];
  int held0 = -1, held1 = -1, held2 = -1;  // the (term, chunk) of each slot
  int i = 0;                               // the slice the warps take next
  for (int gi = 0; gi < p.n_groups; ++gi) {
#pragma unroll
    for (int hd = 0; hd < NH; ++hd)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[hd][ni][e] = 0.0f;

    for (int seg = 0; seg < SEG; ++seg) {
      const int term = SEG > 1 ? split_first(seg) : 0;
      const int slot = n_dc == 1 ? min(term, p.slots - 1) : 0;
      const bf16* sws = sw + slot * slot_size;
      for (int ks = 0, dc = 0, kc = 0; ks < n_seg; ++ks, ++i) {
        if (kc == 0) {
          const int key = term * n_dc + dc;
          const int have = slot == 0 ? held0 : (slot == 1 ? held1 : held2);
          if (have != key) {
            __syncthreads();  // every warp is done with the slot
            load_w(slot, term, dc);
            cp_async_commit();
            cp_async_wait<0>();
            if (slot == 0) held0 = key;
            else if (slot == 1) held1 = key;
            else held2 = key;
          }
        }
        cp_async_wait<kGtStages - 2>();  // slice i (and W) has landed
        __syncthreads();                 // and slice i - 1 is read by all
        load_h((i + kGtStages - 1) % kGtStages);

        const bf16* sa = ring + (i % kGtStages) * kGtRows * kGtHStride;
        const int kw = kc * kGtDepth;
        if (++kc == chunk_k) {
          kc = 0;
          ++dc;
        }
#pragma unroll
        for (int kk = 0; kk < kGtDepth; kk += 16) {
          uint32_t af[4];
          {
            const int r = wm * 16 + (lane & 15);
            const int k = kk + ((lane >> 4) << 3);
            ldsm_x4(af, smem_u32(sa + r * kGtHStride + k));
          }
#pragma unroll
          for (int hd = 0; hd < NH; ++hd) {
            const bf16* swh = sws + hd * p.w_rows * kGtWStride;
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
            for (int ni = 0; ni < 4; ++ni) {
              float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_bf16(part, af, bfr[ni][0], bfr[ni][1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[hd][ni][e] += part[e];
            }
          }
        }
      }
    }

    // the epilogue of group gi, from the accumulators
    const long long grow0 = (long long)gi * p.m;
    float row_ll[2] = {0.0f, 0.0f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + (lane >> 2) + half * 8;
      const int row = m0 + r;
      float grow = 0.0f;
      if constexpr (DH) grow = row < p.m ? p.g[grow0 + row] : 0.0f;
      bf16* out = p.da + (grow0 + row) * ldw + n0 + wn * 32;
      float v[DH ? NH : 1][4][2];  // the row's da
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + 2 * (lane & 3);
        const float2 tv =
            *reinterpret_cast<const float2*>(st + r * kGtTStride + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = row < p.m && n0 + c + e < p.f;
          float a[NH], gr[NH];
#pragma unroll
          for (int hd = 0; hd < NH; ++hd) {
            a[hd] = acc[hd][ni][half * 2 + e] + sb[hd * kTcTileN + c + e];
            gr[hd] = 0.0f;
          }
          if constexpr (DH) {
            if (ok) {
              Fam::grads(a, e ? tv.y : tv.x, nullptr, gr);
#pragma unroll
              for (int hd = 0; hd < NH; ++hd) gr[hd] *= grow;
            }
#pragma unroll
            for (int hd = 0; hd < NH; ++hd) v[hd][ni][e] = gr[hd];
          } else if (ok) {
            row_ll[half] += Fam::ll(a, e ? tv.y : tv.x);
          }
        }
        if constexpr (DH && SEG == 1) {
          // bf16: the pair of genes, one 4-byte store per head
          if (row < p.m && n0 + c < p.fp) {
#pragma unroll
            for (int hd = 0; hd < NH; ++hd)
              *reinterpret_cast<__nv_bfloat162*>(
                  out + hd * p.fp + ni * 8 + 2 * (lane & 3)) =
                  __floats2bfloat162_rn(v[hd][ni][0], v[hd][ni][1]);
          }
        }
      }
      if constexpr (DH) {
        if constexpr (SEG > 1) {
          // float32: the row's terms of da through a transpose across its
          // four lanes, 8 consecutive genes a lane, one 16-byte store per
          // head and pair (six terms a value make the stores count)
          const int q8 = (lane & 3) * 8;
          const bool store = row < p.m && n0 + wn * 32 + q8 < p.fp;
#pragma unroll
          for (int hd = 0; hd < NH; ++hd) {
            bf16 terms[4][2][kSplitTerms];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                split_terms(v[hd][ni][e], terms[ni][e]);
#pragma unroll
            for (int k = 0; k < kSplitTerms; ++k) {
              uint32_t w[4];
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
                w[ni] = bf16_pair(terms[ni][0][k], terms[ni][1][k]);
              const uint4 q = transpose_row(w);
              // the pairs (k, 0), (k, 1), ... whose first term is k
              const int first = k * (2 * kSplitTerms + 1 - k) / 2;
              if (store) {
#pragma unroll
                for (int pr = first; pr < first + kSplitTerms - k; ++pr)
                  *reinterpret_cast<uint4*>(out + pr * width + hd * p.fp +
                                            q8) = q;
              }
            }
          }
        }
        // the column sums of the half's 8 rows (the eight lanes of a
        // column, in order), added to the warp's sums over the groups
#pragma unroll
        for (int hd = 0; hd < NH; ++hd)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = v[hd][ni][e];
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                x += __shfl_xor_sync(0xffffffffu, x, off);
              if (lane < 4)
                sums[(wm * NH + hd) * kTcTileN + wn * 32 + ni * 8 +
                     2 * lane + e] += x;
            }
      }
    }
    if constexpr (!DH) {
      // each row's sum over this thread's genes, then over the four lanes
      // of the row and the two warps of its genes, in order
      __syncthreads();  // the last group's row sums are read
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = row_ll[half] - lg_t[half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0)
          sums[wn * kGtRows + wm * 16 + (lane >> 2) + half * 8] = v;
      }
      __syncthreads();
      for (int r = tid; r < kGtRows && m0 + r < p.m; r += kGtThreads)
        p.part[(long long)blockIdx.y * p.n_groups * p.m + grow0 + m0 + r] =
            sums[r] + sums[kGtRows + r];
    }
  }
  if constexpr (DH) {
    // the column sums of each 64 target rows: the sums of its four warps,
    // in order
    __syncthreads();
    constexpr int kTiles = kGtRows / kGtRowTile;
    constexpr int kWarpsPerTile = kGtRowTile / 16;
    const int row_tiles = (p.m + kGtRowTile - 1) / kGtRowTile;
    for (int i = tid; i < kTiles * NH * kTcTileN; i += kGtThreads) {
      const int s = i / (NH * kTcTileN), rem = i % (NH * kTcTileN);
      const int hd = rem / kTcTileN, c = rem % kTcTileN;
      const int tile = m0 / kGtRowTile + s, gene = n0 + c;
      if (tile < row_tiles && gene < p.fp) {
        float v = 0.0f;
        for (int j = 0; j < kWarpsPerTile; ++j)
          v += sums[((s * kWarpsPerTile + j) * NH + hd) * kTcTileN + c];
        p.part[(long long)tile * width + hd * p.fp + gene] = v;
      }
    }
  }
  cp_async_wait<0>();
}

// The kernel; the forward then sums its row-sum partials over the gene
// tiles into out.
template <class Fam, bool DH, int SEG>
int launch_grouped(const GtArgs& a, float* out, cudaStream_t stream) {
  const dim3 grid((a.m + kGtRows - 1) / kGtRows,
                  (a.f + kTcTileN - 1) / kTcTileN);
  if (grid.x == 0 || grid.y == 0 || a.n_groups == 0) return 0;
  const size_t bytes = gt_smem_bytes(Fam::kHeads, a.w_rows, a.slots);
  if (a.w_rows < kGtDepth || a.w_rows % kGtDepth || a.slots < 1 ||
      a.slots > kSplitTerms || bytes > kGtSmemMax)
    return (int)cudaErrorInvalidValue;
  auto kernel = grouped_tc_heads_kernel<Fam, DH, SEG>;
  if (int err = set_smem(kernel, bytes)) return err;
  kernel<<<grid, kGtThreads, bytes, stream>>>(a);
  if (int err = (int)cudaGetLastError()) return err;
  if constexpr (DH) return 0;
  return launch_reduce(a.part, grid.y, a.n_groups * a.m, out, stream);
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// All return a cudaError_t (0 on success).  family: 0 = Poisson, 1 = NB,
// 2 = ZIP, 3 = ZINB (NH = 1, 2, 2, 3 heads).  b: float32 (NH, f); t:
// (m, f), t_dtype 0 = float32, 1 = bfloat16, shared by the n_groups
// groups; w_rows, slots: W's resident slots, w_rows a multiple of 64,
// slots at most 3 (ops/fused_likelihood.py grouped_tc_plan).  The bf16 entries
// take h: bf16 (n_groups * m, hp) and w: bf16 (hp, NH, fp); the float32
// entries float32 h (n_groups * m, hidden) and the heads' W_k (hidden, f)
// as w0, w1, w2 (null past the family's heads), which they split into
// their terms per pair in the scratch hh (n_groups * m, P, hp) and wp (hp,
// P, NH, fp) first, P = kSplitPairs (the products of the backward read
// them too).  The forwards: part (ceil(f / 64), n_groups * m) scratch and
// out (n_groups * m,).  The gradient kernels: row
// cotangents g (n_groups * m,), da bf16 (n_groups * m, NH * fp) or (bf16
// terms per pair) (n_groups * m, P * NH * fp), db_part float32 (ceil(m /
// 64), NH * fp).

int scvae_grouped_tc_forward(int family, const void* h, const void* w,
                             const float* b, const void* t, int t_dtype,
                             float* part, float* out, int n_groups, int m,
                             int hp, int f, int w_rows, int slots,
                             void* stream) {
  const GtArgs a{nullptr, static_cast<const bf16*>(h),
                 static_cast<const bf16*>(w), b, t, t_dtype, nullptr, part,
                 n_groups, m, hp, f, (f + 7) / 8 * 8, w_rows, slots};
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return launch_grouped<Fam, false, 1>(a, out,
                                         static_cast<cudaStream_t>(stream));
  });
}

int scvae_grouped_tc_gradient(int family, const float* g, const void* h,
                              const void* w, const float* b, const void* t,
                              int t_dtype, void* da, float* db_part,
                              int n_groups, int m, int hp, int f, int w_rows,
                              int slots, void* stream) {
  const GtArgs a{g, static_cast<const bf16*>(h),
                 static_cast<const bf16*>(w), b, t, t_dtype,
                 static_cast<bf16*>(da), db_part, n_groups, m, hp, f,
                 (f + 7) / 8 * 8, w_rows, slots};
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    return launch_grouped<Fam, true, 1>(a, nullptr,
                                        static_cast<cudaStream_t>(stream));
  });
}

int scvae_grouped_tc_f32_forward(int family, const float* h, const float* w0,
                                 const float* w1, const float* w2,
                                 const float* b, const void* t, int t_dtype,
                                 void* hh, void* wp, float* part, float* out,
                                 int n_groups, int m, int hidden, int f,
                                 int w_rows, int slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = (hidden + 7) / 8 * 8, fp = (f + 7) / 8 * 8;
  const GtArgs a{nullptr, static_cast<const bf16*>(hh),
                 static_cast<const bf16*>(wp), b, t, t_dtype, nullptr, part,
                 n_groups, m, hp, f, fp, w_rows, slots};
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    if (int e = launch_split_operands(Fam::kHeads, h, w0, w1, w2, nullptr,
                                      0, static_cast<bf16*>(hh),
                                      static_cast<bf16*>(wp), n_groups * m,
                                      hidden, hp, f, fp, s))
      return e;
    return launch_grouped<Fam, false, kSplitPairs>(a, out, s);
  });
}

int scvae_grouped_tc_f32_gradient(int family, const float* g, const float* h,
                                  const float* w0, const float* w1,
                                  const float* w2, const float* b,
                                  const void* t, int t_dtype, void* hh,
                                  void* wp, void* da, float* db_part,
                                  int n_groups, int m, int hidden, int f,
                                  int w_rows, int slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = (hidden + 7) / 8 * 8, fp = (f + 7) / 8 * 8;
  const GtArgs a{g, static_cast<const bf16*>(hh),
                 static_cast<const bf16*>(wp), b, t, t_dtype,
                 static_cast<bf16*>(da), db_part, n_groups, m, hp, f, fp,
                 w_rows, slots};
  return with_family(family, [&](auto fam) {
    using Fam = typename decltype(fam)::type;
    if (int e = launch_split_operands(Fam::kHeads, h, w0, w1, w2, nullptr,
                                      0, static_cast<bf16*>(hh),
                                      static_cast<bf16*>(wp), n_groups * m,
                                      hidden, hp, f, fp, s))
      return e;
    return launch_grouped<Fam, true, kSplitPairs>(a, nullptr, s);
  });
}

}  // extern "C"
