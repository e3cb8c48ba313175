// XLA FFI custom call: batched lower-triangular solve.
//
// This is the C++ XLA custom-call registration scaffolding SURVEY.md §2.8.4
// prescribes, hosting the batched triangular solve of §2.8.2 (the full-rank
// log-density hot path, reference: src/families/location_scale.jl:59-63
// `scale \ (z - location)`).  Registered for the CPU backend only: on a
// GPU backend the solves stay on XLA's `triangular_solve` (cuBLAS trsm);
// this library is the native path for CPU meshes (tests, multi-process CPU
// clusters).
//
// Layout: the right-hand sides live in (d, n) — row j holds coordinate j of
// all n samples — so forward/backward substitution streams unit-stride
// vectors of length n through the SIMD units:
//
//   X[j, :] = (B[j, :] - sum_{k<j} L[j,k] * X[k, :]) / L[j,j]
//
// Threads split the sample axis into independent column blocks (each block's
// solve is self-contained), off the GIL like ops/cpp/reshuffle.cc.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC \
//            -I $(python -c 'import jax; print(jax.ffi.include_dir())') \
//            -o libadviffi.so ffi_trisolve.cc -lpthread

#include <cstdint>
#include <thread>
#include <vector>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Solve L X = B (trans == 0) or L^T X = B (trans == 1) for the column block
// [s0, s1) of the (d, n) right-hand side.  L is (d, d) row-major, lower
// triangular (the upper triangle is never read).
//
// Output rows are processed in tiles of JB: each already-solved row X[k, :]
// is streamed ONCE per tile (updating all JB pending rows, which stay
// cache-resident) instead of once per pending row — d/JB-fold less read
// traffic, which is what bounds the substitution at large d.
template <typename T>
void SolveBlock(const T* L, const T* B, T* X, int64_t d, int64_t n,
                int64_t s0, int64_t s1, int32_t trans) {
  constexpr int64_t JB = 32;
  if (trans == 0) {
    for (int64_t j0 = 0; j0 < d; j0 += JB) {
      const int64_t j1 = std::min(d, j0 + JB);
      for (int64_t j = j0; j < j1; ++j) {
        const T* Bj = B + j * n;
        T* Xj = X + j * n;
        for (int64_t s = s0; s < s1; ++s) Xj[s] = Bj[s];
      }
      // Contributions of all previously solved rows to this tile: stream
      // X[k, :] once, update every pending row in the tile.
      for (int64_t k = 0; k < j0; ++k) {
        const T* Xk = X + k * n;
        for (int64_t j = j0; j < j1; ++j) {
          const T ljk = L[j * d + k];
          if (ljk == T(0)) continue;
          T* Xj = X + j * n;
          for (int64_t s = s0; s < s1; ++s) Xj[s] -= ljk * Xk[s];
        }
      }
      // Intra-tile triangular solve.
      for (int64_t j = j0; j < j1; ++j) {
        T* Xj = X + j * n;
        const T* Lj = L + j * d;
        for (int64_t k = j0; k < j; ++k) {
          const T ljk = Lj[k];
          if (ljk == T(0)) continue;
          const T* Xk = X + k * n;
          for (int64_t s = s0; s < s1; ++s) Xj[s] -= ljk * Xk[s];
        }
        const T inv = T(1) / Lj[j];
        for (int64_t s = s0; s < s1; ++s) Xj[s] *= inv;
      }
    }
  } else {
    for (int64_t j1 = d; j1 > 0; j1 -= JB) {
      const int64_t j0 = std::max<int64_t>(0, j1 - JB);
      for (int64_t j = j0; j < j1; ++j) {
        const T* Bj = B + j * n;
        T* Xj = X + j * n;
        for (int64_t s = s0; s < s1; ++s) Xj[s] = Bj[s];
      }
      for (int64_t k = j1; k < d; ++k) {
        const T* Xk = X + k * n;
        for (int64_t j = j0; j < j1; ++j) {
          const T lkj = L[k * d + j];  // (L^T)[j, k]
          if (lkj == T(0)) continue;
          T* Xj = X + j * n;
          for (int64_t s = s0; s < s1; ++s) Xj[s] -= lkj * Xk[s];
        }
      }
      for (int64_t j = j1 - 1; j >= j0; --j) {
        T* Xj = X + j * n;
        for (int64_t k = j + 1; k < j1; ++k) {
          const T lkj = L[k * d + j];
          if (lkj == T(0)) continue;
          const T* Xk = X + k * n;
          for (int64_t s = s0; s < s1; ++s) Xj[s] -= lkj * Xk[s];
        }
        const T inv = T(1) / L[j * d + j];
        for (int64_t s = s0; s < s1; ++s) Xj[s] *= inv;
      }
    }
  }
}

template <typename T, ffi::DataType DT>
ffi::Error TrisolveImpl(ffi::Buffer<DT> L, ffi::Buffer<DT> B,
                        ffi::ResultBuffer<DT> X, int32_t trans) {
  auto ldims = L.dimensions();
  auto bdims = B.dimensions();
  if (ldims.size() != 2 || bdims.size() != 2) {
    return ffi::Error::InvalidArgument("trisolve expects L (d,d), B (d,n)");
  }
  const int64_t d = ldims[0];
  const int64_t n = bdims[1];
  if (ldims[1] != d || bdims[0] != d) {
    return ffi::Error::InvalidArgument("trisolve shape mismatch");
  }
  const T* l = L.typed_data();
  const T* b = B.typed_data();
  T* x = X->typed_data();
  if (d == 0 || n == 0) return ffi::Error::Success();

  // Column blocks of >= 1024 samples amortize thread spawn; the solve is
  // O(d^2 n/2) FLOPs so tiny problems stay single-threaded.
  const int64_t min_block = 1024;
  int64_t n_threads =
      std::min<int64_t>(static_cast<int64_t>(
                            std::max(1u, std::thread::hardware_concurrency())),
                        (n + min_block - 1) / min_block);
  if (n_threads <= 1) {
    SolveBlock<T>(l, b, x, d, n, 0, n, trans);
    return ffi::Error::Success();
  }
  const int64_t per = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t s0 = t * per;
    const int64_t s1 = std::min(n, s0 + per);
    if (s0 >= s1) break;
    pool.emplace_back(
        [=]() { SolveBlock<T>(l, b, x, d, n, s0, s1, trans); });
  }
  for (auto& th : pool) th.join();
  return ffi::Error::Success();
}

ffi::Error TrisolveF32(ffi::Buffer<ffi::F32> L, ffi::Buffer<ffi::F32> B,
                       ffi::ResultBuffer<ffi::F32> X, int32_t trans) {
  return TrisolveImpl<float, ffi::F32>(L, B, X, trans);
}

ffi::Error TrisolveF64(ffi::Buffer<ffi::F64> L, ffi::Buffer<ffi::F64> B,
                       ffi::ResultBuffer<ffi::F64> X, int32_t trans) {
  return TrisolveImpl<double, ffi::F64>(L, B, X, trans);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(AdviTrisolveF32, TrisolveF32,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("trans"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(AdviTrisolveF64, TrisolveF64,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::F64>>()
                                  .Arg<ffi::Buffer<ffi::F64>>()
                                  .Ret<ffi::Buffer<ffi::F64>>()
                                  .Attr<int32_t>("trans"));
