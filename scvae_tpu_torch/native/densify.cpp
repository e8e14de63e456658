// Native host-side kernels for the streaming input pipeline.
//
// The reference densifies minibatches with scipy fancy indexing +
// ``.toarray()`` on one thread (``scvae/models/variational_autoencoder.py:
// 997-998``).  Feeding the GPU at gradient-step rate needs the CSR row
// gather + densify to run at memory speed, so this is a small C++ library
// (loaded with ctypes by ``scvae_tpu_torch/native/__init__.py``) doing the
// gather on every core.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread densify.cpp -o libdensify.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Parallel-for over [0, n) with a work-stealing counter.
template <typename F>
void parallel_for(int64_t n, int64_t grain, F&& body) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t max_threads = (n + grain - 1) / grain;
    int64_t n_threads = std::min<int64_t>(hw ? hw : 1, max_threads);
    if (n_threads <= 1) {
        for (int64_t i = 0; i < n; ++i) body(i);
        return;
    }
    std::atomic<int64_t> next(0);
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int64_t t = 0; t < n_threads; ++t) {
        threads.emplace_back([&]() {
            for (;;) {
                int64_t start = next.fetch_add(grain);
                if (start >= n) return;
                int64_t stop = std::min(start + grain, n);
                for (int64_t i = start; i < stop; ++i) body(i);
            }
        });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather `n_rows` rows of a CSR matrix into a dense row-major float32
// buffer `out` of shape (n_rows, n_cols).  `rows` holds the source row
// index for each output row.
void csr_gather_dense_f32(const float* data, const int32_t* indices,
                          const int64_t* indptr, const int64_t* rows,
                          int64_t n_rows, int64_t n_cols, float* out) {
    parallel_for(n_rows, /*grain=*/64, [&](int64_t i) {
        float* out_row = out + i * n_cols;
        std::memset(out_row, 0, sizeof(float) * n_cols);
        int64_t row = rows[i];
        int64_t start = indptr[row];
        int64_t stop = indptr[row + 1];
        for (int64_t k = start; k < stop; ++k) {
            out_row[indices[k]] = data[k];
        }
    });
}

// Same gather, additionally writing each output row's count sum.
void csr_gather_dense_with_sums_f32(const float* data, const int32_t* indices,
                                    const int64_t* indptr, const int64_t* rows,
                                    int64_t n_rows, int64_t n_cols, float* out,
                                    float* count_sums) {
    parallel_for(n_rows, /*grain=*/64, [&](int64_t i) {
        float* out_row = out + i * n_cols;
        std::memset(out_row, 0, sizeof(float) * n_cols);
        int64_t row = rows[i];
        int64_t start = indptr[row];
        int64_t stop = indptr[row + 1];
        double sum = 0.0;
        for (int64_t k = start; k < stop; ++k) {
            out_row[indices[k]] = data[k];
            sum += data[k];
        }
        count_sums[i] = static_cast<float>(sum);
    });
}

// Full-matrix densify (CSR → dense row-major).
void csr_to_dense_f32(const float* data, const int32_t* indices,
                      const int64_t* indptr, int64_t n_rows, int64_t n_cols,
                      float* out) {
    parallel_for(n_rows, /*grain=*/128, [&](int64_t i) {
        float* out_row = out + i * n_cols;
        std::memset(out_row, 0, sizeof(float) * n_cols);
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            out_row[indices[k]] = data[k];
        }
    });
}

}  // extern "C"
