// K6: the semi-explicit stage's reduced step in one pass a lane.
//
// Replaces no TPU kernel: the JAX package forms the reduced right-hand side
// (dolfinx_eqlb_tpu/eqlb/semiexplicit.py::reduced_system_bl) and applies
// the cached interior inverse in plain jnp, which XLA fuses on the TPU.
// The port first wrote both as torch.einsum contractions on the batch-last
// layout; on the card those became a strided copy of the element mass
// matrices Mc (n, nkeep, nkeep, P) a call, a batched cuBLAS gemv at ~10 %
// of the byte rate, a dense GEMM against the 0/1 unit-column map E, the
// inverse product and some 15 small launches a bucket, for a handful of
// multiply-adds a lane.
//
// For each folded lane x = r * P + p (RHS r, patch p) of a bucket of n
// cells and ns spokes a patch:
//     s[c, b]     = sp[patch_idx[c, b], x]
//     resid[c, i] = Fv[c, i, x] - sum_b Mc[c, i, b, p] s[c, b]
//     bz[ucols[c, a]] += resid[c, uslot(a)]                    (E's ones)
//     bz[0]       = sum_c cumalpha[c, p] resid[c, 0]
//                         + cumalpha[exit_idx[c], p] resid[c, K]
// then, on an interior bucket (Ainv given), the bucket's solution in place:
//     y           = Ainv[:, :, p] bz
//     sp[sel[j], x] += y[1 + j],   sp[s K, x] += y[0] cumalpha[s, p]
// and on a boundary bucket bz (Dz, X) is written for the masked solve.  The
// same operations as the einsums; the sums run in another order (and
// contract to FMAs), so the kernel agrees with the plain version to
// rounding, not bitwise.
//
// What bounds it on the card: memory traffic.  At k = 2 in f64, on an
// 8-cell interior patch, a lane reads 2,304 bytes of Mc, 384 of Fv, 648
// of Ainv, 256 of sp and 64 of cumalpha and writes 128: ~3.8 KB against
// ~1,100 flops.  Over the SE cells' call (501,001 patches, 3M patch cells)
// that is ~1.39 GB, ~0.41 ms at 3.35 TB/s.  The design:
//   * one thread per lane; p is the fastest axis of every batch-last
//     table, so every read and write is coalesced across a warp; Mc is
//     streamed in whatever order of its (c, i, b) axes the engine's cache
//     has (strides given, p fastest), with no permuted copy;
//   * the n_rhs lanes that share a patch run in neighbouring blocks, so
//     the later ones find that patch's Mc and Ainv in L2;
//   * resid lives in registers one cell at a time; bz, whose size Dz and
//     entries ucols[c, a] are runtime values, is a column of shared memory
//     a thread (stride blockDim, no bank conflicts);
//   * E enters by its nonzeros (ucols, and uslot(a) fixed by K), not as a
//     dense product; the d0 column's weights are read where they are used;
//   * the bucket's index tables are staged in shared memory once a block;
//   * on interior buckets the epilogue writes the solution into sp, each
//     entry of sel and each d0 row once per lane, so no atomics.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

// canonical cell slot of E's a-th unit column (se_static's uslots):
// entry spoke moments 1..K-1, exit spoke moments K+1..2K-1, interior dofs
template <int K>
__host__ __device__ constexpr int uslot(int a) {
  constexpr int ndiv = K * (K + 1) / 2 - 1;
  return a < K - 1 ? 1 + a
                   : (a < 2 * (K - 1) ? K + 1 + (a - (K - 1))
                                      : 2 * K + ndiv + (a - 2 * (K - 1)));
}

template <int K>
__host__ __device__ constexpr int n_unit() {
  return 2 * (K - 1) + (K - 1) * (K - 2) / 2;
}

// a block's dynamic shared memory: the bz columns, then the index tables
template <typename T, int K>
size_t smem_bytes(int threads, int64_t n, int64_t Dz) {
  constexpr int NKEEP = K * (K + 1);
  const size_t ints = static_cast<size_t>(n) * (NKEEP + n_unit<K>() + 1) +
                      (Dz - 1);
  return static_cast<size_t>(Dz) * threads * sizeof(T) + ints * sizeof(int);
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
reduced_step_kernel(T* __restrict__ sp, const T* __restrict__ Fv,
                    const T* __restrict__ Mc,
                    const int64_t* __restrict__ patch_idx,
                    const int64_t* __restrict__ ucols,
                    const int64_t* __restrict__ exit_idx,
                    const T* __restrict__ cumalpha,
                    const int64_t* __restrict__ sel,
                    const T* __restrict__ Ainv, T* __restrict__ bz_out,
                    int n, int ns, int Dz, int n_rhs, int64_t P,
                    int64_t mc_c, int64_t mc_i, int64_t mc_b) {
  constexpr int NKEEP = K * (K + 1);
  constexpr int NU = n_unit<K>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  T* bz = reinterpret_cast<T*>(smem) + threadIdx.x;  // bz[d * nt]
  int* s_pidx = reinterpret_cast<int*>(reinterpret_cast<T*>(smem) +
                                       static_cast<size_t>(Dz) * nt);
  int* s_ucols = s_pidx + n * NKEEP;
  int* s_exit = s_ucols + n * NU;
  int* s_sel = s_exit + n;
  for (int t = threadIdx.x; t < n * NKEEP; t += nt)
    s_pidx[t] = static_cast<int>(patch_idx[t]);
  for (int t = threadIdx.x; t < n * NU; t += nt)
    s_ucols[t] = static_cast<int>(ucols[t]);
  for (int t = threadIdx.x; t < n; t += nt)
    s_exit[t] = static_cast<int>(exit_idx[t]);
  for (int t = threadIdx.x; t < Dz - 1; t += nt)
    s_sel[t] = static_cast<int>(sel[t]);
  __syncthreads();

  // block b covers patches (b / n_rhs) * nt + [0, nt) of RHS b mod n_rhs
  const int r = static_cast<int>(blockIdx.x % n_rhs);
  const int64_t p =
      static_cast<int64_t>(blockIdx.x / n_rhs) * nt + threadIdx.x;
  if (p >= P) return;
  const int64_t X = n_rhs * P;
  const int64_t x = r * P + p;

  for (int d = 1; d < Dz; ++d) bz[d * nt] = T(0);
  T bz0 = T(0);
  for (int c = 0; c < n; ++c) {
    T s[NKEEP];
#pragma unroll
    for (int b = 0; b < NKEEP; ++b) s[b] = sp[s_pidx[c * NKEEP + b] * X + x];
    const T* Mcc = Mc + c * mc_c + p;
    const T* Fvc = Fv + static_cast<int64_t>(c) * NKEEP * X + x;
    T res[NKEEP];
#pragma unroll
    for (int i = 0; i < NKEEP; ++i) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < NKEEP; ++b) acc += Mcc[i * mc_i + b * mc_b] * s[b];
      res[i] = Fvc[i * X] - acc;
    }
    const T wen = cumalpha[c * P + p];
    const T wex = cumalpha[s_exit[c] * P + p];
    bz0 += wen * res[0] + wex * res[K];
#pragma unroll
    for (int a = 0; a < NU; ++a) bz[s_ucols[c * NU + a] * nt] += res[uslot<K>(a)];
  }
  bz[0] = bz0;

  if (Ainv == nullptr) {  // boundary bucket: bz for the masked solve
    for (int d = 0; d < Dz; ++d) bz_out[d * X + x] = bz[d * nt];
    return;
  }
  // interior bucket: y = Ainv bz, scattered into the solution
  const T* Ap = Ainv + p;
  for (int d = 0; d < Dz; ++d) {
    T y = T(0);
    for (int e = 0; e < Dz; ++e)
      y += Ap[(static_cast<int64_t>(d) * Dz + e) * P] * bz[e * nt];
    if (d == 0) {
      for (int j = 0; j < ns; ++j)
        sp[static_cast<int64_t>(j) * K * X + x] += y * cumalpha[j * P + p];
    } else {
      sp[s_sel[d - 1] * X + x] += y;
    }
  }
}

template <typename T, int K>
int launch_k(void* sp, const void* Fv, const void* Mc, const void* patch_idx,
             const void* ucols, const void* exit_idx, const void* cumalpha,
             const void* sel, const void* Ainv, void* bz_out, int64_t n,
             int64_t ns, int64_t Dz, int64_t n_rhs, int64_t P, int64_t mc_c,
             int64_t mc_i, int64_t mc_b, void* stream) {
  int threads = kMaxThreads;
  while (threads > 32 &&
         smem_bytes<T, K>(threads, n, Dz) > static_cast<size_t>(kDefaultSmem))
    threads /= 2;
  const size_t smem = smem_bytes<T, K>(threads, n, Dz);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = reduced_step_kernel<T, K>;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (P + threads - 1) / threads * n_rhs;
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(sp), static_cast<const T*>(Fv),
      static_cast<const T*>(Mc), static_cast<const int64_t*>(patch_idx),
      static_cast<const int64_t*>(ucols), static_cast<const int64_t*>(exit_idx),
      static_cast<const T*>(cumalpha), static_cast<const int64_t*>(sel),
      static_cast<const T*>(Ainv), static_cast<T*>(bz_out),
      static_cast<int>(n), static_cast<int>(ns), static_cast<int>(Dz),
      static_cast<int>(n_rhs), P, mc_c, mc_i, mc_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(void* sp, const void* Fv, const void* Mc, const void* patch_idx,
           const void* ucols, const void* exit_idx, const void* cumalpha,
           const void* sel, const void* Ainv, void* bz_out, int64_t k,
           int64_t n, int64_t ns, int64_t Dz, int64_t n_rhs, int64_t P,
           int64_t mc_c, int64_t mc_i, int64_t mc_b, void* stream) {
  if (n <= 0 || ns < n || Dz <= 0 || n_rhs <= 0 || P <= 0 ||
      (P + 31) / 32 * n_rhs > 0x7fffffff ||
      (Ainv == nullptr) == (bz_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1:
      return launch_k<T, 1>(sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha,
                            sel, Ainv, bz_out, n, ns, Dz, n_rhs, P, mc_c, mc_i,
                            mc_b, stream);
    case 2:
      return launch_k<T, 2>(sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha,
                            sel, Ainv, bz_out, n, ns, Dz, n_rhs, P, mc_c, mc_i,
                            mc_b, stream);
    case 3:
      return launch_k<T, 3>(sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha,
                            sel, Ainv, bz_out, n, ns, Dz, n_rhs, P, mc_c, mc_i,
                            mc_b, stream);
    case 4:
      return launch_k<T, 4>(sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha,
                            sel, Ainv, bz_out, n, ns, Dz, n_rhs, P, mc_c, mc_i,
                            mc_b, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// (sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha, sel, Ainv, bz,
//  k, n, ns, Dz, n_rhs, P, Mc's c / i / b strides, stream): exactly one of
// Ainv (interior: the solution into sp) and bz (boundary: the reduced
// right-hand side) is null; Mc's p stride is 1
int eqlb_reduced_step_f32(void* sp, const void* Fv, const void* Mc,
                          const void* patch_idx, const void* ucols,
                          const void* exit_idx, const void* cumalpha,
                          const void* sel, const void* Ainv, void* bz,
                          int64_t k, int64_t n, int64_t ns, int64_t Dz,
                          int64_t n_rhs, int64_t P, int64_t mc_c,
                          int64_t mc_i, int64_t mc_b, void* stream) {
  return launch<float>(sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha, sel,
                       Ainv, bz, k, n, ns, Dz, n_rhs, P, mc_c, mc_i, mc_b,
                       stream);
}

int eqlb_reduced_step_f64(void* sp, const void* Fv, const void* Mc,
                          const void* patch_idx, const void* ucols,
                          const void* exit_idx, const void* cumalpha,
                          const void* sel, const void* Ainv, void* bz,
                          int64_t k, int64_t n, int64_t ns, int64_t Dz,
                          int64_t n_rhs, int64_t P, int64_t mc_c,
                          int64_t mc_i, int64_t mc_b, void* stream) {
  return launch<double>(sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha,
                        sel, Ainv, bz, k, n, ns, Dz, n_rhs, P, mc_c, mc_i,
                        mc_b, stream);
}

}  // extern "C"
