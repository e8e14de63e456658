// K1: row gather for device-resident batching.
//
// Replaces the Pallas row-DMA gather of scvae_tpu/ops/gather.py
// (_make_gather_kernel / _gather_call).  B rows picked by an int32 index
// are copied out of a plain row-major (N, F) count matrix and cast to the
// output dtype in the same pass.  The encoder input and the likelihood
// target alias one matrix and ask for one dtype, so one gather with one
// output serves both.  The TPU's packed (N*a, F/a) layout and its F
// alignment rule are not needed here: any F works.
//
// Bound on the H100: bytes.  Each output row reads F source elements once
// and writes F output elements; there is no arithmetic beyond the cast.  At
// the headline shape (B = F = 2048, int16 -> bf16) that is 16.8 MB, 5.0 us
// at 3.35 TB/s.  What holds a gather of that size back is latency: every
// row's load waits on its index, and the whole call is one wave.  So the
// host's plan (ops/gather.py gather_plan) spreads the work over every
// thread at once, on one of two paths:
//
//   vector   rows of whole 16-byte units (F % 8 == 0, 16-byte aligned
//            pointers): each thread reads the indices of kUnroll units
//            first, then keeps their kUnroll 16-byte row loads in flight
//            at once, then converts and stores them with 16-byte stores.
//            The rows are read with the streaming (evict-first) cache
//            hint: a gathered row is read once an epoch, so its misses
//            should evict its own lines, not dirty lines that would have
//            to be written back first.
//   element  any other shape (F = 1 for the constrained Poisson's count
//            sums, a ragged F, unaligned pointers): the flattened (B, F)
//            output spread over the threads, one element each.
//
// A design with Hopper's bulk asynchronous copies (a persistent grid, a
// ring of row pieces in shared memory filled by cp.async.bulk on an
// mbarrier per stage) measured slower than the vector path at every launch
// shape tried, so it is not kept (PERF.md records both designs' times).
//
// The casts go through float (int16 and small int32 counts are exact) and
// then round to nearest even for bf16, which is what Tensor.to does, so the
// result is bit-identical to src.index_select(0, idx).to(dtype).  An index
// outside the matrix traps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI16 = 2, kI32 = 3 };
enum Path { kElement = 0, kVector = 1 };

constexpr int kThreads = 256;
constexpr int kVec = 8;     // elements per unit
constexpr int kUnroll = 4;  // units in flight per thread on the vector path

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  return static_cast<float>(v);
}

template <typename O>
__device__ __forceinline__ O from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// kVec elements as whole 16-byte words: one for int16 / bf16, two for the
// four-byte types.
template <typename T>
struct alignas(16) Unit {
  T v[kVec];
};

// A unit of a source row, read with the streaming cache hint.
template <typename S>
__device__ __forceinline__ Unit<S> load_unit(const S* p) {
  Unit<S> u;
  const int4* q = reinterpret_cast<const int4*>(p);
  int4* d = reinterpret_cast<int4*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Unit<S>) / sizeof(int4)); ++i)
    d[i] = __ldcs(q + i);
  return u;
}

template <typename S, typename O>
__device__ __forceinline__ Unit<O> convert(const Unit<S>& s) {
  Unit<O> o;
#pragma unroll
  for (int i = 0; i < kVec; ++i) o.v[i] = from_float<O>(to_float(s.v[i]));
  return o;
}

__device__ __forceinline__ int checked_row(const int* idx, long long b,
                                           long long n_rows) {
  const int r = idx[b];
  if (r < 0 || r >= n_rows) __trap();  // an index outside the matrix
  return r;
}

// Units are the (B, F / kVec) output chunks in row-major order; a thread
// takes kUnroll of them, kThreads apart, per step of the grid.
template <typename S, typename O>
__global__ void __launch_bounds__(kThreads)
    gather_vector_kernel(const S* __restrict__ src,
                         const int* __restrict__ idx, int n_idx,
                         long long n_rows, int n_cols, O* __restrict__ out) {
  const int per_row = n_cols / kVec;
  const long long units = (long long)n_idx * per_row;
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll +
                        threadIdx.x;
       base < units; base += stride) {
    Unit<S> s[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long u = base + j * kThreads;
      if (u < units) {
        const long long b = u / per_row;
        const int c = (int)(u - b * per_row);
        const int r = checked_row(idx, b, n_rows);
        s[j] = load_unit(src + (long long)r * n_cols + (long long)c * kVec);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long u = base + j * kThreads;
      if (u < units) reinterpret_cast<Unit<O>*>(out)[u] = convert<S, O>(s[j]);
    }
  }
}

// Any shape: one output element per thread and step.
template <typename S, typename O>
__global__ void __launch_bounds__(kThreads)
    gather_element_kernel(const S* __restrict__ src,
                          const int* __restrict__ idx, int n_idx,
                          long long n_rows, int n_cols, O* __restrict__ out) {
  const long long n = (long long)n_idx * n_cols;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long b = i / n_cols;
    const int c = (int)(i - b * n_cols);
    const int r = checked_row(idx, b, n_rows);
    out[i] = from_float<O>(to_float(__ldcs(src + (long long)r * n_cols + c)));
  }
}

template <typename S, typename O>
int launch(const void* src_, const int* idx, int n_idx, long long n_rows,
           int n_cols, void* out_, int path, int grid, cudaStream_t stream) {
  const S* src = static_cast<const S*>(src_);
  O* out = static_cast<O*>(out_);
  if (path == kVector && n_cols % kVec == 0) {
    gather_vector_kernel<S, O><<<grid, kThreads, 0, stream>>>(
        src, idx, n_idx, n_rows, n_cols, out);
  } else if (path == kElement) {
    gather_element_kernel<S, O><<<grid, kThreads, 0, stream>>>(
        src, idx, n_idx, n_rows, n_cols, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch_output(const void* src, const int* idx, int n_idx,
                    long long n_rows, int n_cols, void* out, int out_dtype,
                    int path, int grid, cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch<S, float>(src, idx, n_idx, n_rows, n_cols, out, path, grid,
                            stream);
  if (out_dtype == kBF16)
    return launch<S, __nv_bfloat16>(src, idx, n_idx, n_rows, n_cols, out,
                                    path, grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Output dtype codes: 0 = float32,
// 1 = bfloat16; source codes: 0 = float32, 2 = int16, 3 = int32.  path:
// 0 = element, 1 = vector (16-byte aligned pointers, n_cols % 8 == 0);
// grid blocks of 256 threads (ops/gather.py gather_plan).
int scvae_gather_rows(const void* src, int src_dtype, const int* idx,
                      int n_idx, long long n_rows, int n_cols, void* out,
                      int out_dtype, int path, int grid, void* stream) {
  if (n_idx == 0 || n_cols == 0) return 0;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case kF32:
      return dispatch_output<float>(src, idx, n_idx, n_rows, n_cols, out,
                                    out_dtype, path, grid, s);
    case kI16:
      return dispatch_output<int16_t>(src, idx, n_idx, n_rows, n_cols, out,
                                      out_dtype, path, grid, s);
    case kI32:
      return dispatch_output<int32_t>(src, idx, n_idx, n_rows, n_cols, out,
                                      out_dtype, path, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* scvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
