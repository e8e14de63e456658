// K3's two products on Hopper's tensor cores, for the bf16 backward of the
// base families (count_likelihood_tc.cu) and of the categorised instances
// (categorised_likelihood_tc.cu), whose gradient kernels write bf16(da)
// (M, N = NH * Fp) and its column sums per 64-row tile:
//
//   dh (M, H)       = da W^T     over depth N  (W: (Hp, NH, Fp) = Hp rows of N)
//   dW (NH, H, F)   = h^T da     over depth M, and db (NH, F) = the row-tile
//                                  sums of da added in order
//
// Replaces, with those gradient kernels, the Pallas kernel of
// scvae_tpu/ops/fused_likelihood.py that _fused_backward drives (K3).
//
// Bound on the H100: bytes at the shapes the training path gives them (NB
// at 2,048 rows: 21 MB for dh, 22 MB for dW at 3.35 TB/s against 4.3 GFLOP
// at 989 TFLOP/s; Poisson-cat with 32 heads: da alone is 268 MB).  What the
// design does about it:
//
// - wgmma.mma_async m64nNk16 (bf16 in, float32 accumulators) reads both
//   operands from shared memory.  A block tile is 128 x 256: two consumer
//   warpgroups of 64 rows each span dh's whole width (Hp = 256), so da is
//   read once.  With promoted sums (below) the tile is 128 x 128.
// - One producer warp keeps a ring of stages 64 deep full with TMA
//   (cp.async.bulk.tensor.2d) into 128-byte-swizzled shared memory, with an
//   mbarrier per stage for "full" (the copy's bytes landed) and one for
//   "empty" (both warpgroups' products have read it).  The hardware computes
//   the addresses and zero-fills past every edge.
// - dh's operands are K-major as they lie (da rows, W rows); dW's are both
//   MN-major (h^T and da): the descriptors' transpose bits read them in
//   place, with no copy.  The tensor maps are encoded on the host with
//   cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, so
//   nothing links libcuda.
// - The depth is split where the output tiles alone would leave SMs idle
//   (dh at 2,048 rows has only 16), as far as the card holds the clusters
//   at once.  The S splits of one output tile are the S blocks of a
//   thread-block cluster (1, 1, S).
//   After its mainloop each block stages its float32 tile in its own shared
//   memory; block r then sums its share of the tile's rows over the S
//   staged tiles in rank order, through distributed shared memory (all S
//   loads in flight before the first add), and writes them.  One launch, no
//   partial arrays in device memory, no atomics: the sums repeat bit for
//   bit.  Without a split the accumulators go straight to the output.
// - dW's blocks of the first row tile also sum db's row-tile partials, in
//   order, each rank every S-th column of the tile.
// - Promoted sums (PROMOTE): every 16 stages (1,024 deep) the products,
//   summed inside the tensor cores from zeroed registers, are added to the
//   running sums in float32, so a large running sum inside the tensor
//   cores does not truncate later products (tools/product_precision.py
//   reads both against the depth they sum).  The second set of
//   accumulators halves the tile to 128 x 128.  The planner asks for it
//   where one split would sum more than TC_PROMOTE_DEPTH.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scvae {
namespace {

constexpr int kPRows = 128;       // rows of a block tile: two warpgroups of 64
constexpr int kPDepth = 64;       // depth of a stage: one 128-byte bf16 row
constexpr int kPConsumers = 256;  // two consumer warpgroups
constexpr int kPThreads = kPConsumers + 32;  // and the producer warp
constexpr int kPBox = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 TMA box
constexpr int kPMaxSplits = 8;      // blocks of a cluster (the portable cap)
constexpr int kPromoteStages = 16;  // stages summed inside the tensor cores
                                    // between promotions (1,024 deep)

// Shared memory of a block with tiles 128 x BN: the ring (per stage the A
// tile, 16 KB, then the B tile), reused after the mainloop for the staged
// float32 tile red[128][BN + 8]; then the barriers.  1,024 bytes of slack
// align the ring for the swizzle.
template <int BN>
struct ProductShape {
  static constexpr int kStageA = kPRows * kPDepth * 2;
  static constexpr int kStage = kStageA + BN * kPDepth * 2;
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kRing = kStage * kStages;
  static constexpr int kRedLd = BN + 8;  // float2 stores free of conflicts
  static_assert(kPRows * kRedLd * 4 <= kRing, "the staged tile fits the ring");
  static constexpr size_t kSmem = 1024 + kRing + 2 * 8 * kStages;
};

// One product C = A B of m x n outputs over depth k, split into stages of
// tiles_per_split per cluster rank.  Column c of row r goes to
// out[(c / seg) * out_seg + r * out_ld + c % seg] for r < valid_r and
// c % seg < valid_c.  db_part (row_tiles, n), if given: db[(c / seg) *
// valid_c + c % seg] = the in-order sum of its column c.
struct ProductArgs {
  int m, n, k;
  int tiles_per_split;
  float* out;
  long long out_seg;
  int out_ld, seg, valid_r, valid_c;
  const float* db_part;
  float* db;
  int row_tiles;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// The box of `map` at element coordinates (c0 innermost, c1) into shared
// memory at dst; its bytes complete on barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Four floats at shared address addr of cluster rank `rank`.
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products' issue and wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a 128-byte-swizzled shared-memory tile (its 1,024-byte
// atoms aligned): start address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// k-step kk (16 deep) of a stage's tile at shared address `tile`.  K-major
// (rows of 128 bytes along the depth, 8-row atoms 1,024 bytes apart): the
// step advances 32 bytes along the rows.  MN-major (TMA boxes of 64 depth
// rows x 64 columns, 8 KB apart along the columns): the step advances 16
// rows of 128 bytes.
template <bool MN>
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  if constexpr (MN)
    return smem_desc(tile + kk * 16 * 128, kPBox, 1024);
  else
    return smem_desc(tile + kk * 32, 16, 1024);
}

// d (64 x 256, float32 fragments) += A (64 x 16) B (16 x 256) from shared
// memory; d is overwritten when scale_d is 0.  TA / TB: A / B MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
#endif
}

// d (64 x 128, float32 fragments) += A (64 x 16) B (16 x 128) from shared
// memory; d is overwritten when scale_d is 0.  TA / TB: A / B MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
#endif
}

// Output element (row, col) of the product into its segment of out.
__device__ __forceinline__ void store_out(const ProductArgs& a, int row,
                                          int col, float v) {
  const int hd = col / a.seg, cc = col - hd * a.seg;
  if (row < a.valid_r && col < a.n && cc < a.valid_c)
    a.out[hd * a.out_seg + (long long)row * a.out_ld + cc] = v;
}

template <int BN, bool MN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  if constexpr (BN == 256)
    wgmma_m64n256<MN, MN>(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n128<MN, MN>(d, desc_a, desc_b, scale_d);
}

// One block of a 128 x BN output tile and its share of the depth (cluster
// rank r of S takes stages [r tiles_per_split, (r + 1) tiles_per_split)).
// Warps 0-7 are the two consumer warpgroups, warp 8 the producer.  MN:
// dW's layout (A = h^T, B = da, both MN-major; the row tiles vary fastest,
// blockIdx.x, since they share the da tiles that do not fit in L2);
// otherwise dh's (A = da, B = W^T, both K-major; the column tiles vary
// fastest).
template <bool MN, int BN, bool PROMOTE>
__global__ void __launch_bounds__(kPThreads, 1)
    tc_product_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const ProductArgs args) {
  using S = ProductShape<BN>;
  constexpr int kAcc = BN / 2;
  extern __shared__ __align__(1024) unsigned char p_smem_raw[];
  unsigned char* base =
      p_smem_raw + ((1024 - (smem_addr(p_smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(base);
  const uint32_t full0 = ring + S::kRing;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * S::kStages;

  const int tid = threadIdx.x;
  const int m_tile = MN ? blockIdx.x : blockIdx.y;
  const int n_tile = MN ? blockIdx.y : blockIdx.x;
  const int m0 = m_tile * kPRows, n0 = n_tile * BN;
  uint32_t rank, n_ranks;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n_ranks));
  const int k_tiles = (args.k + kPDepth - 1) / kPDepth;
  const int kt0 = min((int)rank * args.tiles_per_split, k_tiles);
  const int n_k = min(kt0 + args.tiles_per_split, k_tiles) - kt0;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kPConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kPConsumers) {
    if (tid == kPConsumers) {  // one lane of the producer warp
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      for (int i = 0; i < n_k; ++i) {
        const int s = i % S::kStages;
        mbar_wait(empty0 + 8 * s, ((i / S::kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, S::kStage);
        const uint32_t sa = ring + s * S::kStage, sb = sa + S::kStageA;
        const int k0 = (kt0 + i) * kPDepth;
        if constexpr (MN) {
          tma_load(sa, &map_a, m0, k0, full);
          tma_load(sa + kPBox, &map_a, m0 + 64, k0, full);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(sb + j * kPBox, &map_b, n0 + 64 * j, k0, full);
        } else {
          tma_load(sa, &map_a, k0, m0, full);
          tma_load(sb, &map_b, k0, n0, full);
        }
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg: rows wg * 64 + [0, 64) of the tile, which start
    // 8 KB into the A tile in both layouts
    const int wg = tid / 128;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    float part[PROMOTE ? kAcc : 1];
#pragma unroll
    for (int i = 0; i < (PROMOTE ? kAcc : 1); ++i) part[i] = 0.0f;
    for (int i = 0; i < n_k; ++i) {
      const int s = i % S::kStages;
      mbar_wait(full0 + 8 * s, (i / S::kStages) & 1);
      const uint32_t sa = ring + s * S::kStage + wg * kPBox;
      const uint32_t sb = ring + s * S::kStage + S::kStageA;
      wgmma_fence();
      if constexpr (PROMOTE) {
        // a chunk's first stage overwrites the partial sums
        const int keep = i % kPromoteStages != 0;
#pragma unroll
        for (int kk = 0; kk < kPDepth / 16; ++kk)
          wgmma_tile<BN, MN>(part, tile_desc<MN>(sa, kk),
                             tile_desc<MN>(sb, kk), kk > 0 || keep);
      } else {
#pragma unroll
        for (int kk = 0; kk < kPDepth / 16; ++kk)
          wgmma_tile<BN, MN>(acc, tile_desc<MN>(sa, kk),
                             tile_desc<MN>(sb, kk), 1);
      }
      wgmma_commit();
      if (i > 0) {  // the previous stage's products are done with it
        wgmma_wait<1>();
        mbar_arrive(empty0 + 8 * ((i - 1) % S::kStages));
      }
      if constexpr (PROMOTE) {
        if ((i + 1) % kPromoteStages == 0 || i + 1 == n_k) {
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int j = 0; j < kAcc; ++j) acc[j] += part[j];
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const int lane = tid % 32;
    const int r = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
    if (n_ranks == 1) {  // no split: the fragments go straight out
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            store_out(args, m0 + r + 8 * half, c + e, acc[4 * j + 2 * half + e]);
      }
    } else {
      // both warpgroups are done with the ring before it holds the tile
      asm volatile("bar.sync 1, %0;\n" ::"n"(kPConsumers) : "memory");
      float* red = reinterpret_cast<float*>(base);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(red + r * S::kRedLd + c) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(red + (r + 8) * S::kRedLd + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }

  if (n_ranks > 1) {
    cluster_sync();  // every rank's tile is staged
    // this rank's rows: the ranks' tiles summed in rank order, every
    // rank's four values loaded before the first is added
    const int per = (kPRows + (int)n_ranks - 1) / (int)n_ranks;
    const int r_lo = (int)rank * per, r_hi = min(kPRows, r_lo + per);
    constexpr int kQuads = BN / 4;
    for (int e = tid; e < (r_hi - r_lo) * kQuads; e += kPThreads) {
      const int r = r_lo + e / kQuads, c = (e % kQuads) * 4;
      const uint32_t addr = ring + (r * S::kRedLd + c) * 4;
      float4 v[kPMaxSplits];
#pragma unroll
      for (int q = 0; q < kPMaxSplits; ++q)
        if (q < (int)n_ranks) v[q] = ld_cluster_f4(addr, q);
      float4 sum = v[0];
#pragma unroll
      for (int q = 1; q < kPMaxSplits; ++q)
        if (q < (int)n_ranks) {
          sum.x += v[q].x;
          sum.y += v[q].y;
          sum.z += v[q].z;
          sum.w += v[q].w;
        }
      const int row = m0 + r, col = n0 + c;
      store_out(args, row, col, sum.x);
      store_out(args, row, col + 1, sum.y);
      store_out(args, row, col + 2, sum.z);
      store_out(args, row, col + 3, sum.w);
    }
  }

  // db: the first row tile's ranks take every n_ranks-th column of the
  // tile; each column's row-tile sums are added in order, eight loads in
  // flight
  if (args.db != nullptr && m_tile == 0) {
    for (int c = tid * (int)n_ranks + (int)rank; c < BN;
         c += kPThreads * (int)n_ranks) {
      const int col = n0 + c;
      const int hd = col / args.seg, cc = col - hd * args.seg;
      if (col >= args.n || cc >= args.valid_c) continue;
      const float* part = args.db_part + col;
      float s = 0.0f;
      int j = 0;
      for (; j + 8 <= args.row_tiles; j += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = part[(long long)(j + u) * args.n];
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
      }
      for (; j < args.row_tiles; ++j) s += part[(long long)j * args.n];
      args.db[hd * args.valid_c + cc] = s;
    }
  }
  if (n_ranks > 1) cluster_sync();  // the tiles stay until all have read
}

// cuTensorMapEncodeTiled from the driver, found at run time.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a row-major bf16 array of `outer` rows x `inner` elements
// (rows 16-byte aligned), boxes of box_outer rows x box_inner elements
// (box_inner * 2 = 128 bytes), 128-byte swizzle, zeros past the edges.
int tensor_map(CUtensorMap* map, const void* ptr, int inner, int outer,
               int box_inner, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool MN, int BN, bool PROMOTE>
int launch_tiles(const CUtensorMap& map_a, const CUtensorMap& map_b,
                 const ProductArgs& args, int splits, cudaStream_t stream) {
  using S = ProductShape<BN>;
  const unsigned m_tiles = (args.m + kPRows - 1) / kPRows;
  const unsigned n_tiles = (args.n + BN - 1) / BN;
  auto kernel = tc_product_kernel<MN, BN, PROMOTE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  cudaLaunchConfig_t config = {};
  config.gridDim = MN ? dim3(m_tiles, n_tiles, splits)
                      : dim3(n_tiles, m_tiles, splits);
  config.blockDim = dim3(kPThreads);
  config.dynamicSmemBytes = S::kSmem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  config.attrs = cluster;
  config.numAttrs = 1;
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&config, kernel, map_a, map_b, args);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left behind for a later launch
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The instance of (MN, promote): 128 x 256 tiles, or 128 x 128 with
// promoted sums; the tensor maps' B boxes are 64 deep and as wide as the
// tile (MN: 64 wide, BN / 64 boxes per stage).
template <bool MN>
int launch_product(const void* a, int a_inner, int a_outer, const void* b,
                   int b_inner, int b_outer, const ProductArgs& args,
                   int splits, int promote, cudaStream_t stream) {
  if (splits < 1 || splits > kPMaxSplits || args.tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  if (args.m == 0 || args.n == 0 || args.k == 0) return 0;
  const int bn = promote ? 128 : 256;
  CUtensorMap map_a, map_b;
  int err = MN ? tensor_map(&map_a, a, a_inner, a_outer, 64, kPDepth)
               : tensor_map(&map_a, a, a_inner, a_outer, kPDepth, kPRows);
  if (!err)
    err = MN ? tensor_map(&map_b, b, b_inner, b_outer, 64, kPDepth)
             : tensor_map(&map_b, b, b_inner, b_outer, kPDepth, bn);
  if (err) return err;
  return promote
             ? launch_tiles<MN, 128, true>(map_a, map_b, args, splits, stream)
             : launch_tiles<MN, 256, false>(map_a, map_b, args, splits,
                                            stream);
}

}  // namespace
}  // namespace scvae

using namespace scvae;

extern "C" {

// Both return a cudaError_t (0 on success).  splits: blocks of a cluster
// (1 to 8), each taking tiles_per_split depth stages of 64; promote: 1 for
// promoted sums (128 x 128 tiles).  Operands are bf16 with rows that are
// multiples of 8 elements.

// dh (m, hidden) = da (m, k) w^T for w (hp, k): the heads' weights
// (hp, NH, fp) as hp rows of k = NH * fp.
int scvae_tc_dh(const void* da, const void* w, float* dh, int m, int hidden,
                int hp, int k, int splits, int tiles_per_split, int promote,
                void* stream) {
  const ProductArgs args{m,       hp,      k,       tiles_per_split,
                         dh,      0,       hidden,  hp,
                         m,       hidden,  nullptr, nullptr,
                         0};
  return launch_product<false>(da, k, m, w, k, hp, args, splits, promote,
                               static_cast<cudaStream_t>(stream));
}

// dw (n_heads, hidden, f) = h^T da over the m rows, for h (m, hp) and da
// (m, n_heads * fp); db (n_heads, f) = the sum of db_part's row_tiles rows
// (row_tiles, n_heads * fp), in order.
int scvae_tc_dw(const void* h, const void* da, const float* db_part,
                float* dw, float* db, int n_heads, int m, int hidden, int hp,
                int f, int splits, int tiles_per_split, int row_tiles,
                int promote, void* stream) {
  const int fp = (f + 7) / 8 * 8, n = n_heads * fp;
  const ProductArgs args{hp,  n,  m,       tiles_per_split, dw,
                         (long long)hidden * f,  f,  fp,  hidden,  f,
                         db_part, db,  row_tiles};
  return launch_product<true>(h, hp, m, da, n, m, args, splits, promote,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
