// K1: row gather for device-resident batching.
//
// Replaces the Pallas row-DMA gather of scvae_tpu/ops/gather.py
// (_make_gather_kernel / _gather_call).  B rows picked by an int32 index
// are copied out of a plain row-major (N, F) count matrix and cast to the
// output dtype in the same pass.  The encoder input and the likelihood
// target alias one matrix and ask for one dtype, so one gather with one
// output serves both.  The TPU's packed (N*a, F/a) layout and its F
// alignment rule are not needed here: any F works, the tail of a row is
// masked.
//
// Bound on the H100: bytes.  Each output row reads F source elements once
// and writes F output elements; there is no arithmetic beyond the cast.
// One block per gathered row, 16-byte vector loads and stores where F and
// the pointers allow it, plain element copies otherwise.
//
// The casts go through float (int16 and small int32 counts are exact) and
// then round to nearest even for bf16, which is what Tensor.to does, so the
// result is bit-identical to src.index_select(0, idx).to(dtype).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI16 = 2, kI32 = 3 };

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per vector chunk

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

template <typename T>
struct alignas(sizeof(T) * kVec) Chunk {
  T v[kVec];
};

// `vec` selects the 8-element vector path; the host sets it only when
// F % 8 == 0 and every pointer is 16-byte aligned.
template <typename S, typename O>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const S* __restrict__ src, const int* __restrict__ idx,
                       long long n_rows, int n_cols, O* __restrict__ out,
                       int vec) {
  const long long b = blockIdx.x;
  const int r = idx[b];
  if (r < 0 || r >= n_rows) __trap();  // an index outside the matrix
  const S* row = src + (long long)r * n_cols;
  O* o = out + b * n_cols;
  if (vec) {
    const int n_chunks = n_cols / kVec;
    for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
      const Chunk<S> s = reinterpret_cast<const Chunk<S>*>(row)[c];
      Chunk<O> a;
#pragma unroll
      for (int i = 0; i < kVec; ++i) a.v[i] = from_float<O>(to_float(s.v[i]));
      reinterpret_cast<Chunk<O>*>(o)[c] = a;
    }
  } else {
    for (int c = threadIdx.x; c < n_cols; c += kThreads)
      o[c] = from_float<O>(to_float(row[c]));
  }
}

template <typename S, typename O>
int launch(const void* src, const int* idx, int n_idx, long long n_rows,
           int n_cols, void* out, int vec, cudaStream_t stream) {
  gather_rows_kernel<S, O><<<n_idx, kThreads, 0, stream>>>(
      static_cast<const S*>(src), idx, n_rows, n_cols, static_cast<O*>(out),
      vec);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch_output(const void* src, const int* idx, int n_idx,
                    long long n_rows, int n_cols, void* out, int out_dtype,
                    int vec, cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch<S, float>(src, idx, n_idx, n_rows, n_cols, out, vec, stream);
  if (out_dtype == kBF16)
    return launch<S, __nv_bfloat16>(src, idx, n_idx, n_rows, n_cols, out, vec,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Output dtype codes: 0 = float32,
// 1 = bfloat16; source codes: 0 = float32, 2 = int16, 3 = int32.
int scvae_gather_rows(const void* src, int src_dtype, const int* idx,
                      int n_idx, long long n_rows, int n_cols, void* out,
                      int out_dtype, int vec, void* stream) {
  if (n_idx == 0 || n_cols == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case kF32:
      return dispatch_output<float>(src, idx, n_idx, n_rows, n_cols, out,
                                    out_dtype, vec, s);
    case kI16:
      return dispatch_output<int16_t>(src, idx, n_idx, n_rows, n_cols, out,
                                      out_dtype, vec, s);
    case kI32:
      return dispatch_output<int32_t>(src, idx, n_idx, n_rows, n_cols, out,
                                      out_dtype, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* scvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
