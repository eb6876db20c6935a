// K2: the global dof combine of the semi-explicit equilibration, as one
// fused gather.
//
// Replaces the Pallas TPU kernel dolfinx_eqlb_tpu/ops/lane_select.py::_kernel
// (driver _run; entries lane_select_sum / _multi / _offsets) together with
// the 128-lane row gather that fed it (eqlb/engine.py _row_gather_select).
//
// Every global RT dof d receives the sum of its 2 (facet dof) or 3 (cell
// dof) patch contributions, which sit at flat positions src[d, 0..2] of
// the concatenated bucket solutions flat (R, L):
//     out[r, d] = (flat[r, src[d, 0]] + flat[r, src[d, 1]])
//                 + flat[r, src[d, 2]]            (third term only for d >= nfk)
// Absent contributors point at a zero pad slot.  The summation order is the
// reference combine's (eqlb/engine.py:1040-1041), so this kernel and its
// plain PyTorch version agree bitwise.  It is a gather, not atomics, so the
// result is deterministic.
//
// What bounds it on the card: memory traffic — 12 bytes of index and two or
// three scattered element reads per output element, no arithmetic to speak
// of.  The TPU fetched whole 128-lane rows (its gather is index-rate-bound)
// and selected a lane in VMEM; on the card that row fetch is wasted traffic,
// so the design reads the elements directly: one thread per output element,
// consecutive threads write consecutive outputs and read consecutive index
// triples.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void combine_gather_kernel(const T* __restrict__ flat,
                                      const int32_t* __restrict__ src,
                                      T* __restrict__ out, int64_t R,
                                      int64_t L, int64_t ndofs, int64_t nfk) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= R * ndofs) return;
  const int64_t r = t / ndofs;
  const int64_t d = t - r * ndofs;
  const T* f = flat + r * L;
  const int32_t* s = src + 3 * d;
  T v = f[s[0]] + f[s[1]];
  if (d >= nfk) v = v + f[s[2]];
  out[t] = v;
}

template <typename T>
int launch(const void* flat, const void* src, void* out, int64_t R, int64_t L,
           int64_t ndofs, int64_t nfk, void* stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (R * ndofs + kThreads - 1) / kThreads;
  combine_gather_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(flat), static_cast<const int32_t*>(src),
      static_cast<T*>(out), R, L, ndofs, nfk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int eqlb_combine_gather_f32(const void* flat, const void* src, void* out,
                            int64_t R, int64_t L, int64_t ndofs, int64_t nfk,
                            void* stream) {
  return launch<float>(flat, src, out, R, L, ndofs, nfk, stream);
}

int eqlb_combine_gather_f64(const void* flat, const void* src, void* out,
                            int64_t R, int64_t L, int64_t ndofs, int64_t nfk,
                            void* stream) {
  return launch<double>(flat, src, out, R, L, ndofs, nfk, stream);
}

}  // extern "C"
