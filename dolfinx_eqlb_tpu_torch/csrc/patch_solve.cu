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

// K3: the same pivot-free solve, batch-major, one thread block per system.
//
// Replaces the Pallas TPU kernel's batch-major entry
// dolfinx_eqlb_tpu/ops/patch_solve.py::batched_kkt_solve (the moveaxis into
// _kernel), the solve of the KKT mode's full patch systems: A (N, D, D) and
// b (N, D, R), row-major per system, D = 16-56 at RT2 and up to 110.
//
// What bounds it on the card: at D = 56 a system is ~3,100 values and
// ~D^3/3 = 58,000 multiply-adds, so one thread per system (K1's design)
// would stream every update through L2.  Design: the block stages the
// augmented system [A | b] (D x (D + R), row stride W = D + R) once in
// dynamic shared memory with coalesced loads and eliminates it there.  Each
// elimination step j first turns column j below the pivot into the
// multipliers, then the block updates the trailing (i > j, c > j) entries of
// [A | b] -- the forward substitution rides along in the b columns -- with a
// warp on consecutive columns of a row (no bank conflicts; row j and the
// multiplier are broadcasts).  Back substitution sweeps the columns from the
// last: divide x_j by its pivot, then subtract its column from the rows
// above.  x is written once.  Shared memory is D (D + R) sizeof(T): 12.8 KB
// at D = 56 in f32, 97.7 KB at D = 110 in f64; the wrapper refuses more
// than the block limit.  Packing several small systems into one block,
// wgmma and TMA are later work.

constexpr int kBmWarps = 4;  // blockDim = (32, kBmWarps)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use

template <typename T>
__global__ void __launch_bounds__(32 * kBmWarps)
lu_solve_bm_kernel(const T* __restrict__ A, const T* __restrict__ b,
                   T* __restrict__ x, int D, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);
  const int W = D + R;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  constexpr int nthr = 32 * kBmWarps;
  const int64_t p = blockIdx.x;
  const T* Ap = A + p * D * D;
  const T* bp = b + p * D * R;

  for (int e = tid; e < D * D; e += nthr) {
    const int i = e / D;
    S[i * W + (e - i * D)] = Ap[e];
  }
  for (int e = tid; e < D * R; e += nthr) {
    const int i = e / R;
    S[i * W + D + (e - i * R)] = bp[e];
  }
  __syncthreads();

  // column elimination fused with forward substitution
  for (int j = 0; j < D; ++j) {
    const T piv = S[j * W + j];
    for (int i = j + 1 + tid; i < D; i += nthr) S[i * W + j] /= piv;
    __syncthreads();
    for (int i = j + 1 + ty; i < D; i += kBmWarps) {
      const T l = S[i * W + j];
      for (int c = j + 1 + tx; c < W; c += 32)
        S[i * W + c] -= l * S[j * W + c];
    }
    __syncthreads();
  }
  // back substitution, column by column
  for (int j = D - 1; j >= 0; --j) {
    for (int r = tid; r < R; r += nthr) S[j * W + D + r] /= S[j * W + j];
    __syncthreads();
    for (int t = tid; t < j * R; t += nthr) {
      const int i = t / R;
      const int r = t - i * R;
      S[i * W + D + r] -= S[i * W + j] * S[j * W + D + r];
    }
    __syncthreads();
  }

  T* xp = x + p * D * R;
  for (int e = tid; e < D * R; e += nthr) {
    const int i = e / R;
    xp[e] = S[i * W + D + (e - i * R)];
  }
}

template <typename T>
int launch_bm(const void* A, const void* b, void* x, int64_t N, int64_t D,
              int64_t R, void* stream) {
  const int64_t smem = D * (D + R) * static_cast<int64_t>(sizeof(T));
  if (N <= 0 || N > 0x7fffffff || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lu_solve_bm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lu_solve_bm_kernel<T><<<static_cast<unsigned>(N), dim3(32, kBmWarps),
                          static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<int>(D), static_cast<int>(R));
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

int eqlb_lu_solve_bm_f32(const void* A, const void* b, void* x, int64_t N,
                         int64_t D, int64_t R, void* stream) {
  return launch_bm<float>(A, b, x, N, D, R, stream);
}

int eqlb_lu_solve_bm_f64(const void* A, const void* b, void* x, int64_t N,
                         int64_t D, int64_t R, void* stream) {
  return launch_bm<double>(A, b, x, N, D, R, stream);
}

}  // extern "C"
