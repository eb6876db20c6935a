// K1: batched pivot-free LU solve of small dense systems, batch-last.
//
// Replaces the Pallas TPU kernel dolfinx_eqlb_tpu/ops/patch_solve.py::_kernel
// (grid driver _solve_padded, entry batched_kkt_solve_bl).
//
// For X systems stored batch-last, A (D, D, X) and b (D, R, X), it returns
// x = A^-1 b by LU without pivoting: the elimination is fused with the
// forward substitution, then back substitution follows.  Pivot-free is the
// contract: the callers' systems are SPD (the reduced H(div=0) matrices of
// the semi-explicit equilibration, identity rows on masked columns).
//
// What bounds it on the card: memory traffic.  Each system does O(D^3)
// multiply-adds on O(D^2) values, so at the main path's D <= 9 the work per
// byte is tiny.  Design: one thread per system.  The batch is the minor
// axis, so element (i, c) of system p sits at (i * D + c) * X + p and
// neighbouring threads touch neighbouring addresses on every access — the
// batch-last layout coalesces with no relayout.  The kernel copies A into a
// scratch buffer and b into the output, then eliminates in place in global
// memory (served mostly from L1/L2).  The TPU kernel's pad of D to a
// multiple of 8 was a Mosaic unroll artefact and is dropped; any D works.
// Holding the system in registers or shared memory is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void lu_solve_bl_kernel(const T* __restrict__ A,
                                   const T* __restrict__ b,
                                   T* __restrict__ As, T* __restrict__ x,
                                   int64_t D, int64_t R, int64_t X) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= X) return;
  for (int64_t e = 0; e < D * D; ++e) As[e * X + p] = A[e * X + p];
  for (int64_t e = 0; e < D * R; ++e) x[e * X + p] = b[e * X + p];

  // column elimination fused with forward substitution
  for (int64_t j = 0; j < D; ++j) {
    const T piv = As[(j * D + j) * X + p];
    for (int64_t i = j + 1; i < D; ++i) {
      const T l = As[(i * D + j) * X + p] / piv;
      for (int64_t c = j + 1; c < D; ++c)
        As[(i * D + c) * X + p] -= l * As[(j * D + c) * X + p];
      for (int64_t r = 0; r < R; ++r)
        x[(i * R + r) * X + p] -= l * x[(j * R + r) * X + p];
    }
  }
  // back substitution
  for (int64_t j = D - 1; j >= 0; --j) {
    const T piv = As[(j * D + j) * X + p];
    for (int64_t r = 0; r < R; ++r) {
      T acc = 0;
      for (int64_t c = j + 1; c < D; ++c)
        acc += As[(j * D + c) * X + p] * x[(c * R + r) * X + p];
      x[(j * R + r) * X + p] = (x[(j * R + r) * X + p] - acc) / piv;
    }
  }
}

template <typename T>
int launch(const void* A, const void* b, void* As, void* x, int64_t D,
           int64_t R, int64_t X, void* stream) {
  constexpr int kThreads = 128;
  const int64_t blocks = (X + kThreads - 1) / kThreads;
  lu_solve_bl_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(As),
      static_cast<T*>(x), D, R, X);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int eqlb_lu_solve_bl_f32(const void* A, const void* b, void* As, void* x,
                         int64_t D, int64_t R, int64_t X, void* stream) {
  return launch<float>(A, b, As, x, D, R, X, stream);
}

int eqlb_lu_solve_bl_f64(const void* A, const void* b, void* As, void* x,
                         int64_t D, int64_t R, int64_t X, void* stream) {
  return launch<double>(A, b, As, x, D, R, X, stream);
}

}  // extern "C"
