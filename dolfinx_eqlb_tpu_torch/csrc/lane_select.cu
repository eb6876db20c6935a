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

// K4: the double-single combine of f64 solutions.
//
// Replaces the Pallas TPU kernel dolfinx_eqlb_tpu/ops/lane_select.py::
// _kernel_ds (driver _run_ds, entry lane_select_ds) together with its row
// gather and the f64 reconstruction around it (eqlb/engine.py _ds_combine,
// _row_gather_select_ds).  Each contributor value v is split into
// hi = f32(v), lo = f32(v - hi); the hi parts of contributors 0 and 1 are
// added with Knuth's 2Sum in f32, their lo parts plus the 2Sum error in
// f32; the result is f64(hi) + f64(lo), and a cell dof's third contributor
// is added afterwards in f64 as f64(hi2) + f64(lo2), as the reference's
// separate class-2 pass does.  Every operation is an explicitly rounded
// intrinsic, so nvcc can neither contract nor reorder the 2Sum, and the
// kernel is bitwise equal to its plain PyTorch version.
//
// What bounds it on the card: memory traffic, as for K2 (twice the bytes
// per element in f64).  The TPU rode the f64 values through its f32-only
// row gather as (hi, lo) lane pairs; the card gathers f64 natively, so the
// design is K2's: one thread per output element, the split done in
// registers after the load.

__device__ __forceinline__ void split_ds(double v, float& hi, float& lo) {
  hi = __double2float_rn(v);
  lo = __double2float_rn(__dsub_rn(v, static_cast<double>(hi)));
}

__global__ void ds_combine_gather_kernel(const double* __restrict__ flat,
                                         const int32_t* __restrict__ src,
                                         double* __restrict__ out, int64_t R,
                                         int64_t L, int64_t ndofs,
                                         int64_t nfk) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= R * ndofs) return;
  const int64_t r = t / ndofs;
  const int64_t d = t - r * ndofs;
  const double* f = flat + r * L;
  const int32_t* s = src + 3 * d;
  float h0, l0, h1, l1;
  split_ds(f[s[0]], h0, l0);
  split_ds(f[s[1]], h1, l1);
  // Knuth 2Sum: sum + err == h0 + h1 exactly
  const float sum = __fadd_rn(h0, h1);
  const float bb = __fsub_rn(sum, h0);
  const float err =
      __fadd_rn(__fsub_rn(h0, __fsub_rn(sum, bb)), __fsub_rn(h1, bb));
  const float lo = __fadd_rn(__fadd_rn(l0, l1), err);
  double v = __dadd_rn(static_cast<double>(sum), static_cast<double>(lo));
  if (d >= nfk) {
    float h2, l2;
    split_ds(f[s[2]], h2, l2);
    v = __dadd_rn(v, __dadd_rn(static_cast<double>(h2),
                               static_cast<double>(l2)));
  }
  out[t] = v;
}

int launch_ds(const void* flat, const void* src, void* out, int64_t R,
              int64_t L, int64_t ndofs, int64_t nfk, void* stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (R * ndofs + kThreads - 1) / kThreads;
  ds_combine_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(flat), static_cast<const int32_t*>(src),
      static_cast<double*>(out), R, L, ndofs, nfk);
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

int eqlb_ds_combine_gather_f64(const void* flat, const void* src, void* out,
                               int64_t R, int64_t L, int64_t ndofs,
                               int64_t nfk, void* stream) {
  return launch_ds(flat, src, out, R, L, ndofs, nfk, stream);
}

}  // extern "C"
