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
// byte is tiny: the solve must read A and b once and write x once,
// D^2 + 2 D R values per system.  The batch is the minor axis, so element
// (i, c) of system p sits at (i * D + c) * X + p and neighbouring systems
// sit at neighbouring addresses — the batch-last layout coalesces with no
// relayout.  Three routes; the wrapper picks one from the shape
// (ops/patch_solve.py::k1_plan):
//
// * "tile" (lu_solve_bl_tile_kernel, below), the small systems: one thread
//   per system, each block's systems staged in shared memory, factored
//   once, right-hand sides swept a column at a time; A is read once, b
//   read once, x written once and nothing else leaves the chip.
// * "block" (lu_solve_bl_block_kernel, below), the larger systems (RT4 and
//   RT5 give D = 28-81, and small batches of any D): one thread block per
//   system, [A | b] staged in shared memory and eliminated there by every
//   thread of the block, one barrier a step.  It takes any system whose
//   [A | b] fits in a block's shared memory.
// * "global" (lu_solve_bl_kernel), the rest: one thread per system, copies
//   A into a global scratch buffer and b into the output, then eliminates
//   in place in global memory, every update a read-modify-write through
//   L1/L2 with int64 index arithmetic.  It takes any D.
//
// The TPU kernel's pad of D to a multiple of 8 was a Mosaic unroll artefact
// and is dropped; any D works.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use

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

// K1, tile route: the same batch-last solve, each block's systems staged in
// shared memory.
//
// Replaces the same Pallas kernel as the global route above.  What held the
// global route at ~9 % of its bound on the H100 (D = 9, R = 9): a global
// scratch of the size of A written and read back before any work, every
// elimination update a read-modify-write of a working set far larger than
// L1, and int64 index arithmetic on runtime D and R with no loop unrolled.
// Design: a block of NT systems, one thread each, no barrier anywhere — a
// thread touches only its own system.
// - Stage: the thread copies its A into dynamic shared memory with 4- or
//   8-byte cp.async (rows of the batch-last arrays start misaligned at an
//   odd X, so no 16-byte copy), entry e at S[e * NT + t]: row e of the
//   batch-last array, systems p0 ... p0 + NT, is one coalesced read, and
//   with t the fastest index the shared accesses are free of bank
//   conflicts in f32 and f64 (a system laid out contiguously, stride D^2,
//   would conflict at D = 4, 8, 12, 16).  Column 0 of b is read into
//   registers while A arrives.
// - Factor in place: for j ascending and each i > j, l = S[i, j] / S[j, j]
//   (the plain version's division), stored over S[i, j], then the trailing
//   row update.  No global scratch.
// - Sweep: for each right-hand side r, column r of b is held in registers
//   (y[DMAX], loops unrolled to the template bound DMAX, so the array never
//   goes to local memory; each unrolled loop leaves at D by a branch that
//   is uniform across the block, so a system smaller than DMAX issues no
//   masked work), forward-substituted with the stored multipliers (j
//   ascending: the plain version's fused forward step, operation for
//   operation), back-substituted with U (c ascending, then the division by
//   the pivot) and written as column r of x.
// NT is a compile-time constant of each (dtype, DMAX) tile, so every
// shared access is a row base plus an immediate offset: with a runtime NT
// ptxas hoisted the sweep's addresses out of the column loop and spilled
// in f64.  Each tile's NT and register budget (__launch_bounds__ minimum
// blocks) are set so that its smallest systems keep several blocks on an
// SM; shared memory, D^2 NT values a block, is what bounds the larger ones.
// On-chip state is D^2 + D values per system whatever R is, which is what
// the interior inverse build (R = D) needs.  The wrapper caps D per dtype
// and takes it only for batches large enough to fill the card (k1_plan,
// from H100 measurements in PERF.md); the block route below serves the
// rest.

// one cp.async of a single value (4 or 8 bytes) into shared memory
template <typename T>
__device__ __forceinline__ void cp_async_value(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T)))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int DMAX, int NT, int kMinBlocks>
__global__ void __launch_bounds__(NT, kMinBlocks)
lu_solve_bl_tile_kernel(const T* __restrict__ A, const T* __restrict__ b,
                        T* __restrict__ x, int D, int R, int64_t X) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t p = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (p >= X) return;
  T* S = reinterpret_cast<T*>(smem) + threadIdx.x;  // entry e at S[e * NT]
  const int rs = D * NT;  // row stride of S

  {
    const T* src = A + p;
    for (int e = 0; e < D * D; ++e, src += X) cp_async_value(S + e * NT, src);
  }
  const int64_t RX = static_cast<int64_t>(R) * X;  // row stride of b and x
  const T* bp = b + p;
  T y[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    if (i >= D) break;
    y[i] = bp[i * RX];
  }
  cp_async_wait_all();

  // factor: multipliers below the diagonal, U on and above it
  for (int j = 0; j < D; ++j) {
    const T* Sj = S + j * rs;
    const T piv = Sj[j * NT];
    for (int i = j + 1; i < D; ++i) {
      T* Si = S + i * rs;
      const T l = Si[j * NT] / piv;
      Si[j * NT] = l;
      for (int c = j + 1; c < D; ++c) Si[c * NT] -= l * Sj[c * NT];
    }
  }

  T* xp = x + p;
  for (int r = 0; r < R; ++r) {
    if (r > 0) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        if (i >= D) break;
        y[i] = bp[r * X + i * RX];
      }
    }
    // forward substitution, j ascending
#pragma unroll
    for (int j = 0; j < DMAX - 1; ++j) {
      if (j + 1 >= D) break;
#pragma unroll
      for (int i = j + 1; i < DMAX; ++i) {
        if (i >= D) break;
        y[i] -= S[i * rs + j * NT] * y[j];
      }
    }
    // back substitution, j descending from D - 1
#pragma unroll
    for (int j = DMAX - 1; j >= 0; --j) {
      if (j < D) {
        T acc = 0;
#pragma unroll
        for (int c = j + 1; c < DMAX; ++c) {
          if (c >= D) break;
          acc += S[j * rs + c * NT] * y[c];
        }
        y[j] = (y[j] - acc) / S[j * rs + j * NT];
      }
    }
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i >= D) break;
      xp[r * X + i * RX] = y[i];
    }
  }
}

template <typename T, int DMAX, int NT, int kMinBlocks>
int launch_bl_tile_dmax(const void* A, const void* b, void* x, int64_t D,
                        int64_t R, int64_t X, cudaStream_t stream) {
  const int64_t smem = D * D * NT * static_cast<int64_t>(sizeof(T));
  const int64_t blocks = (X + NT - 1) / NT;
  if (smem > kMaxSmem || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lu_solve_bl_tile_kernel<T, DMAX, NT, kMinBlocks>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), NT, static_cast<size_t>(smem),
           stream>>>(static_cast<const T*>(A), static_cast<const T*>(b),
                     static_cast<T*>(x), static_cast<int>(D),
                     static_cast<int>(R), X);
  return static_cast<int>(cudaGetLastError());
}

// The tiles built, (type, DMAX, NT, minimum blocks per SM), by type and
// DMAX ascending: the one list of them in C.  A launch takes the first tile
// of its type with D <= DMAX.  ops/patch_solve.py::K1_TILES names the same
// (DMAX, NT) pairs, and the wrapper holds them against
// eqlb_lu_solve_bl_tiles before the tile route's first launch.
#define EQLB_K1_TILES(X)                                            \
  X(float, 8, 128, 8) X(float, 16, 64, 12) X(float, 32, 32, 4)      \
  X(double, 8, 64, 12) X(double, 16, 32, 10) X(double, 32, 32, 1)

template <typename T>
int launch_bl_tile(const void* A, const void* b, void* x, int64_t D,
                   int64_t R, int64_t X, int64_t nt, void* stream) {
  if (X <= 0 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define EQLB_K1_DISPATCH(TYPE, DMAX, NT, MINB)                            \
  if (std::is_same<T, TYPE>::value && D <= DMAX)                          \
    return nt == NT ? launch_bl_tile_dmax<TYPE, DMAX, NT, MINB>(          \
                          A, b, x, D, R, X, s)                            \
                    : static_cast<int>(cudaErrorInvalidValue);
  EQLB_K1_TILES(EQLB_K1_DISPATCH)
#undef EQLB_K1_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1, block route: the same batch-last solve, one thread block per
// system, for the systems the tile route serves badly.
//
// Replaces the same Pallas kernel as the routes above.  What held the
// global route, which served these sizes before, at 5-24x behind
// torch.linalg.solve on the H100 (D = 28-49 at X = 70-1,073): one thread
// per system leaves the card nearly empty at such X (70 systems are 70
// threads of one SM), and each thread runs ~2/3 D^3 + D^2 R dependent
// read-modify-writes of global memory.  The tile route, one thread per
// system as well, has the same floor at small X.  What bounds this kernel
// instead: at D = 49 a system is ~4,800 values and ~97,000 multiply-adds
// of elimination, so the work is on chip; each update is a load and a
// store of shared memory (16 bytes in f64 against the SM's 128 a clock).
// On the H100 that traffic is the limit (~22 us of SM time a system at
// D = R = 49 in f64, 5 blocks an SM, at X = 1,073 and 131,072 alike;
// PERF.md), not HBM (8-10 % of the bound) nor the barrier a step.  Design:
// - Fill the card: block x takes system x, so 70 systems occupy 70 SMs.
//   The block's threads come from the wrapper
//   (ops/patch_solve.py::k1_block_threads): more where few blocks share an
//   SM.  Blocks of 2 or 4 adjacent systems (whole 32-byte sectors of the
//   batch-last rows) were slower at every shape on the H100 (PERF.md).
// - Stage: [A | b] is copied with 4- or 8-byte cp.async (rows of the
//   batch-last arrays start misaligned at an odd X) into dynamic shared
//   memory as a D x (D + R) tile at row stride ld, odd where it fits
//   (column reads by consecutive lanes then fall in distinct banks).
//   Nothing goes through a global scratch.
// - Eliminate with one barrier a step.  At the barrier that opens step j,
//   column j below the diagonal holds the multipliers l_i = a_ij / a_jj
//   (the plain version's division) and rows > j the trailing values.  In
//   step j each thread first forms its rows' multipliers of step j + 1,
//   a_i,j+1 - l_i a_j,j+1 divided by the next pivot, which it recomputes
//   from values no thread writes in step j, and stores them over column
//   j + 1; then the warps share the trailing update of columns j + 2 ...
//   W - 1 of [A | b] (the forward substitution rides in the b columns), a
//   warp on consecutive columns of a row.  Thread 0 writes the pivot of
//   step j in place, from the same three values by the same fma, so every
//   copy of a pivot is bitwise one value.  Every read in a step is of a
//   value written before its barrier, and each value is written by one
//   thread: there is no shared-memory race.
// - Back substitution, right-hand sides in parallel: a thread per column r
//   of b, for j descending x_j = (y_j - sum_c U_jc x_c) / U_jj, U read
//   from shared memory (a broadcast: the warp's threads read one address),
//   y and x in the tile's b columns; no barrier.  Each x_j is written once,
//   straight to the batch-last output.
// Every shared access is a row base plus a column offset in int; the only
// int64 arithmetic is the global address.  Tensor cores (a blocked
// trailing update on f64 DMMA), a persistent grid that overlaps the next
// system's load with this one's elimination, and TMA are not used.

constexpr int kBlockMaxThreads = 512;

// one elimination update, a - l u, as one fma: the pivots are formed by
// this function in two places and must agree bit for bit
template <typename T>
__device__ __forceinline__ T elim(T a, T l, T u) {
  return fma(-l, u, a);
}

template <typename T>
__global__ void __launch_bounds__(kBlockMaxThreads)
lu_solve_bl_block_kernel(const T* __restrict__ A, const T* __restrict__ b,
                         T* __restrict__ x, int D, int R, int ld,
                         int64_t X) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);  // entry (i, c) at S[i * ld + c]
  const int W = D + R;
  const int tx = threadIdx.x, ty = threadIdx.y, nw = blockDim.y;
  const int tid = ty * 32 + tx, nt = 32 * nw;
  const int64_t p = blockIdx.x;

  // stage [A | b]: warps over rows, lanes over columns
  for (int i = ty; i < D; i += nw) {
    const T* Ai = A + p + static_cast<int64_t>(i) * D * X;
    const T* bi = b + p + static_cast<int64_t>(i) * R * X;
    for (int c = tx; c < W; c += 32)
      cp_async_value(S + i * ld + c,
                     c < D ? Ai + static_cast<int64_t>(c) * X
                           : bi + static_cast<int64_t>(c - D) * X);
  }
  cp_async_wait_all();
  __syncthreads();

  // the multipliers of step 0
  for (int i = 1 + tid; i < D; i += nt) S[i * ld] /= S[0];
  __syncthreads();

  for (int j = 0; j < D; ++j) {
    const T* Sj = S + j * ld;
    // the pivot of step j, in place (step 0's is the staged value)
    if (j > 0 && tid == 0) S[j * ld + j] = elim(Sj[j], Sj[j - 1], Sj[j - ld]);
    if (j + 1 < D) {
      // the multipliers of step j + 1, rows j + 2 ... D - 1
      const T u = Sj[j + 1];
      const T* Sn = Sj + ld;  // row j + 1
      for (int i = j + 2 + tid; i < D; i += nt) {
        T* Si = S + i * ld;
        Si[j + 1] = elim(Si[j + 1], Si[j], u) / elim(Sn[j + 1], Sn[j], u);
      }
      // the trailing update, rows j + 1 ... D - 1, columns j + 2 ... W - 1
      for (int i = j + 1 + ty; i < D; i += nw) {
        T* Si = S + i * ld;
        const T l = Si[j];
        for (int c = j + 2 + tx; c < W; c += 32) Si[c] = elim(Si[c], l, Sj[c]);
      }
    }
    __syncthreads();
  }

  // back substitution: a thread per right-hand side
  const int64_t RX = static_cast<int64_t>(R) * X;
  for (int r = tid; r < R; r += nt) {
    T* y = S + D + r;  // column r of b, row stride ld
    T* xo = x + p + static_cast<int64_t>(r) * X;
    for (int j = D - 1; j >= 0; --j) {
      const T* Uj = S + j * ld;
      T acc = 0;
      for (int c = j + 1; c < D; ++c) acc = fma(Uj[c], y[c * ld], acc);
      const T xj = (y[j * ld] - acc) / Uj[j];
      y[j * ld] = xj;
      xo[j * RX] = xj;
    }
  }
}

template <typename T>
int launch_bl_block(const void* A, const void* b, void* x, int64_t D,
                    int64_t R, int64_t X, int64_t threads, void* stream) {
  const int64_t size = sizeof(T);
  const int64_t W = D + R;
  // the row stride: W, made odd where the tile still fits
  const int64_t ld = (W % 2 == 1 || D * (W + 1) * size > kMaxSmem) ? W : W + 1;
  const int64_t smem = D * ld * size;
  if (X <= 0 || D < 1 || R < 1 || smem > kMaxSmem || X > 0x7fffffff ||
      threads % 32 != 0 || threads < 32 || threads > kBlockMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lu_solve_bl_block_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(X),
           dim3(32, static_cast<unsigned>(threads / 32)),
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<int>(D), static_cast<int>(R), static_cast<int>(ld), X);
  return static_cast<int>(cudaGetLastError());
}

// K3: the same pivot-free solve, batch-major, one thread block per system.
//
// Replaces the Pallas TPU kernel's batch-major entry
// dolfinx_eqlb_tpu/ops/patch_solve.py::batched_kkt_solve (the moveaxis into
// _kernel), the solve of the KKT mode's full patch systems: A (N, D, D) and
// b (N, D, R), row-major per system, D = 16-56 at RT2 and up to 128.
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

// K3, register route: the same batch-major solve for D <= 64, each system's
// trailing block held in registers.
//
// Replaces the same Pallas entry as the shared-memory route above
// (dolfinx_eqlb_tpu/ops/patch_solve.py::batched_kkt_solve); the wrapper
// picks the route (ops/patch_solve.py::k3_plan).
//
// What bounds the shared-memory route on this card is not HBM (its bound is
// ~1 ms per 131072 systems at D = 56 in f64) but shared-memory traffic and
// barriers: every multiply-add of the trailing update does two shared loads
// and a store (~175k accesses per system at D = 56) and each system crosses
// 4D block barriers.  Design: one system per block of TR x TC threads laid
// out over [A | b] (W = D + R columns); the register route is TR x TC =
// 8 x 16 (128 threads).  Thread (ty, tx) owns rows i = ty (mod TR) and
// columns c = tx (mod TC) and keeps its MR x MC values in registers (MR, MC
// template parameters, so the tile never leaves them); the loads go
// straight from device memory, TC consecutive lanes reading TC consecutive
// values of a row.  Elimination step j has ONE barrier: before
// it the owners of row j write it, scaled by the pivot's reciprocal, to a
// shared U | y store (U[j, j] holds the reciprocal itself), and the owners
// of column j write it to a double-buffered column (the buffer of step j is
// rewritten at step j + 2, after every thread has passed the barrier of
// step j + 1).  After it every thread updates its tile,
// a[i][c] -= col[i] U[j, c], with at most MR x MC FMAs against MR + MC
// shared loads, all broadcasts or TC consecutive words.  The update reads
// without bounds checks: a row i <= j or a column c <= j of a tile is dead
// by then (written out, or never read).  Row j's slot in the store spans
// the TC MC columns a tile can name (plus one, an odd row stride against
// bank conflicts), and its owners write all of the slot's columns they
// hold (zero outside j <= c < W) once, at step j, before its barrier; so
// every read is of a value written before the barrier it follows, and no
// slot is written again: the kernel has no shared-memory race and reads
// nothing uninitialised.  The step loop is split into blocks of TR (one
// thread row's worth), so the row and column blocks a step leaves behind
// are dropped at compile time.  Back substitution runs in one warp from the
// scaled store, with no block barrier: lane l owns rows l + 32 s; for j
// descending the owner's value is x_j, broadcast by a shuffle, and every
// lane subtracts U[i, j] x_j from its rows i < j.  x is written once.
// On the H100 the kernel is bound by the latency of each step's chain (the
// pivot's shuffle and reciprocal, the store, the barrier, the shared
// loads), not by HBM or the FP64 pipe; the register budget per tile is cut
// so that more blocks share an SM (reg_min_blocks below).  Two steps a
// barrier (row j + 1 taking step j by shuffles inside its warp, bitwise the
// same result) was slower at every tile measured: the two reciprocals in
// series cost more than the barrier saved.  Overlapping the next system's
// load (cp.async / TMA), several small systems per block and tensor cores
// are later work.
//
// K3, wide route: the same kernel on a 16 x 16 thread layout (256 threads)
// for 64 < D <= 128, the KKT systems of RT3 on unstructured meshes
// (D = 75, 90, 105) and of RT4 (D = 104, 108), which the 8 x 16 layout
// would cover only with 14 x 7 = 98 values a thread (~196 registers in
// f64, spilled).  Twice the thread rows halve MR: tiles 5 x 5, 6 x 6 and
// 7 x 7 cover D + R <= 80, 96 and 112 with at most 49 values a thread,
// which fit the 128 registers of two blocks an SM in f64.  What bounds the
// shared-memory route it replaces for these D is the same as at D <= 64:
// at D = 105 it makes ~D^3 shared accesses and ~4D = 420 block barriers a
// system; here a step costs one barrier and MR + MC shared loads a
// thread.  The U | y store grows to D (16 MC + 1) values (97 KB at
// D = 105 in f64), dynamic shared memory past 48 KB; with the registers it
// allows two f64 blocks an SM at D > 80.  Tried beside it at
// D = 75 / 90 / 105 on the H100 and not kept (PERF.md): 16 x 32 threads
// (7 x 4 tiles), slower at every D; 8 x 16 with tiles up to 14 x 7, which
// spill in f64 and lose in f32 and at D = 75; a blocked LU on the FP64
// tensor cores with its trailing matrix in shared memory, slower at every
// D (bound by the shared-memory traffic of the trailing updates).
//
// The wide route's last tile, 8 x 8, covers D + R <= 128: the KKT systems
// of RT3 on unstructured meshes at D = 120 (interior patches of 8 cells),
// which the TPU's VMEM rule left to a pivoted library solve.  64 values a
// thread leave one f64 block an SM by registers (255 of them), so its
// U | y store (123 KB at D = 120 in f64) costs nothing more; f32 runs
// three blocks an SM under an 80-register cap (140 bytes spilled), faster
// than two without spills.  Tried beside it at D = 120 on the H100 and
// not kept (PERF.md): a store packed by rows (each row's slot starting at
// its first live column block, 72 KB in f64), slower at the same
// occupancy in both dtypes, and slower than the kept tile where it lets a
// second f64 block in at 128 registers (with spills); 16 x 32 threads
// with 8 x 4 tiles, slower in both dtypes.

// per layout and tile: the blocks per SM the register budget is cut for,
// and the unroll of the step loop (H100 measurements, PERF.md); no tile
// spills but the wide route's f32 8 x 8 (above)
template <typename T, int TR, int MR, int MC>
constexpr int reg_min_blocks() {
  constexpr int vals = MR * MC;
  if (TR == 16) {  // wide route, 256 threads a block
    if (sizeof(T) == 8) return vals <= 25 ? 3 : vals <= 49 ? 2 : 1;
    return vals <= 36 ? 4 : 3;
  }
  if (sizeof(T) == 8) return vals <= 8 ? 12 : vals <= 28 ? 6 : 4;
  return vals <= 8 ? 16 : vals <= 28 ? 8 : 4;
}

// f64 <8, 7, 4> spills 48 bytes at unroll 2 under its 80-register cap
template <typename T, int TR, int MR, int MC>
constexpr int reg_unroll() {
  constexpr int vals = MR * MC;
  if (TR == 16) return sizeof(T) == 8 && vals <= 49 ? 1 : 2;
  return vals <= 8 ? 8 : (sizeof(T) == 8 && vals <= 28) ? 1 : 2;
}

template <typename T, int TR, int TC, int MR, int MC,
          int kMinBlocks = reg_min_blocks<T, TR, MR, MC>(),
          int kUnroll = reg_unroll<T, TR, MR, MC>()>
__global__ void __launch_bounds__(TR * TC, kMinBlocks)
lu_solve_bm_reg_kernel(const T* __restrict__ A, const T* __restrict__ b,
                       T* __restrict__ x, int D, int R) {
  // a thread row is TC lanes of one warp, and a block of TR steps spans
  // whole thread columns
  static_assert(TC <= 32 && 32 % TC == 0 && TC % TR == 0, "layout");
  constexpr int kRows = TR * MR;  // rows the tile covers, >= D
  constexpr int kCols = TC * MC;  // columns the tile covers, >= W
  // the store's row stride: odd, so the back substitution's reads down a
  // column (one row a lane) fall in distinct banks
  constexpr int kLd = kCols + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* colbuf = reinterpret_cast<T*>(smem);  // 2 x kRows: column j
  T* U = colbuf + 2 * kRows;  // D x kLd: [U | y] scaled, row j at j
  const int W = D + R;
  const int tid = threadIdx.x;
  const int ty = tid / TC, tx = tid % TC;
  const int lane0 = tid & 31 & ~(TC - 1);  // first lane of this thread row
  const int64_t p = blockIdx.x;
  const T* Ap = A + p * D * D;
  const T* bp = b + p * D * R;

  T a[MR][MC];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int i = ty + TR * r;
#pragma unroll
    for (int q = 0; q < MC; ++q) {
      const int c = tx + TC * q;
      const T* src = c < D ? Ap + i * D + c : bp + i * R + (c - D);
      a[r][q] = (i < D && c < W) ? *src : T(0);
    }
  }

  // column elimination fused with forward substitution; step
  // j = TR rb + jj is row rb of thread row jj and column rb / (TC / TR) of
  // thread column j % TC
#pragma unroll
  for (int rb = 0; rb < MR; ++rb) {
    constexpr int kQ = TC / TR;
    const int qb = rb / kQ;
#pragma unroll kUnroll
    for (int jj = 0; jj < TR; ++jj) {
      const int j = TR * rb + jj;
      if (j >= D) break;
      T* col = colbuf + (j & 1) * kRows;
      // every thread row fetches its entry in column j; in the thread row
      // of row j that is the pivot
      const T piv = __shfl_sync(0xffffffffu, a[rb][qb], lane0 | (j % TC));
      if (ty == jj) {
        const T inv = T(1) / piv;
#pragma unroll
        for (int q = qb; q < MC; ++q) {
          const int c = tx + TC * q;
          U[j * kLd + c] =
              c == j ? inv : (c > j && c < W) ? a[rb][q] * inv : T(0);
        }
      }
      if (tx == j % TC) {
#pragma unroll
        for (int r = rb; r < MR; ++r) col[ty + TR * r] = a[r][qb];
      }
      __syncthreads();
      T u[MC];
#pragma unroll
      for (int q = qb; q < MC; ++q) u[q] = U[j * kLd + tx + TC * q];
#pragma unroll
      for (int r = rb; r < MR; ++r) {
        const T l = col[ty + TR * r];
#pragma unroll
        for (int q = qb; q < MC; ++q) a[r][q] = fma(-l, u[q], a[r][q]);
      }
    }
  }
  if (tid >= 32) return;

  // back substitution in warp 0; lane owns rows lane + 32 s
  constexpr int kSlots = (kRows + 31) / 32;
  const int lane = tid;
  T* xp = x + p * D * R;
  for (int rr = 0; rr < R; ++rr) {
    T y[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = lane + 32 * s;
      y[s] = i < D ? U[i * kLd + D + rr] : T(0);
    }
#pragma unroll
    for (int sb = kSlots - 1; sb >= 0; --sb) {
#pragma unroll
      for (int jl = 31; jl >= 0; --jl) {
        const int j = 32 * sb + jl;
        if (j < D) {
          const T xj = __shfl_sync(0xffffffffu, y[sb], jl);
#pragma unroll
          for (int s = 0; s <= sb; ++s) {
            const int i = lane + 32 * s;
            if (i < j) y[s] -= U[i * kLd + j] * xj;
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = lane + 32 * s;
      if (i < D) xp[i * R + rr] = y[s];
    }
  }
}

template <typename T, int TR, int TC, int MR, int MC>
int launch_bm_reg_tile(const void* A, const void* b, void* x, int64_t N,
                       int64_t D, int64_t R, cudaStream_t stream) {
  if (N <= 0 || N > 0x7fffffff || D < 1 || R < 1 || D > TR * MR ||
      D + R > TC * MC)
    return static_cast<int>(cudaErrorInvalidValue);
  // column buffers and [U | y] at row stride TC MC + 1: <= 42 KB for every
  // register tile, up to 133 KB for the wide route's 8 x 8 in f64
  const int64_t smem = (2 * TR * MR + D * (TC * MC + 1)) *
                       static_cast<int64_t>(sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lu_solve_bm_reg_kernel<T, TR, TC, MR, MC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(N), TR * TC, static_cast<size_t>(smem),
           stream>>>(static_cast<const T*>(A), static_cast<const T*>(b),
                     static_cast<T*>(x), static_cast<int>(D),
                     static_cast<int>(R));
  return static_cast<int>(cudaGetLastError());
}

// The tiles (MR, MC) built, smallest first, of the register route (8 x 16
// threads) and of the wide route (16 x 16): the one list of each in C.
// ops/patch_solve.py::K3_REG_TILES and K3_WIDE_TILES name the same, and the
// wrapper holds each against eqlb_lu_solve_bm_reg_tiles /
// eqlb_lu_solve_bm_wide_tiles before the route's first launch.
#define EQLB_K3_REG_TILES(X) X(4, 2) X(7, 4) X(8, 5)
#define EQLB_K3_WIDE_TILES(X) X(5, 5) X(6, 6) X(7, 7) X(8, 8)

template <typename T>
int launch_bm_reg(const void* A, const void* b, void* x, int64_t N, int64_t D,
                  int64_t R, int64_t mr, int64_t mc, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define EQLB_K3_DISPATCH(MR, MC) \
  if (mr == MR && mc == MC)      \
    return launch_bm_reg_tile<T, 8, 16, MR, MC>(A, b, x, N, D, R, s);
  EQLB_K3_REG_TILES(EQLB_K3_DISPATCH)
#undef EQLB_K3_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_bm_wide(const void* A, const void* b, void* x, int64_t N,
                   int64_t D, int64_t R, int64_t mr, int64_t mc,
                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define EQLB_K3_DISPATCH(MR, MC) \
  if (mr == MR && mc == MC)      \
    return launch_bm_reg_tile<T, 16, 16, MR, MC>(A, b, x, N, D, R, s);
  EQLB_K3_WIDE_TILES(EQLB_K3_DISPATCH)
#undef EQLB_K3_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
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

int eqlb_lu_solve_bl_tile_f32(const void* A, const void* b, void* x,
                              int64_t D, int64_t R, int64_t X, int64_t nt,
                              void* stream) {
  return launch_bl_tile<float>(A, b, x, D, R, X, nt, stream);
}

int eqlb_lu_solve_bl_tile_f64(const void* A, const void* b, void* x,
                              int64_t D, int64_t R, int64_t X, int64_t nt,
                              void* stream) {
  return launch_bl_tile<double>(A, b, x, D, R, X, nt, stream);
}

// writes up to cap values BYTES0, DMAX0, NT0, BYTES1, ... of the tile
// route's built tiles to out (BYTES: 4 float, 8 double) and returns the
// number of tiles
int eqlb_lu_solve_bl_tiles(int64_t* out, int64_t cap) {
#define EQLB_K1_VALUES(TYPE, DMAX, NT, MINB) \
  static_cast<int64_t>(sizeof(TYPE)), DMAX, NT,
  const int64_t tiles[] = {EQLB_K1_TILES(EQLB_K1_VALUES)};
#undef EQLB_K1_VALUES
  constexpr int64_t n = sizeof(tiles) / sizeof(tiles[0]);
  for (int64_t e = 0; e < n && e < cap; ++e) out[e] = tiles[e];
  return static_cast<int>(n / 3);
}

int eqlb_lu_solve_bl_block_f32(const void* A, const void* b, void* x,
                               int64_t D, int64_t R, int64_t X,
                               int64_t threads, void* stream) {
  return launch_bl_block<float>(A, b, x, D, R, X, threads, stream);
}

int eqlb_lu_solve_bl_block_f64(const void* A, const void* b, void* x,
                               int64_t D, int64_t R, int64_t X,
                               int64_t threads, void* stream) {
  return launch_bl_block<double>(A, b, x, D, R, X, threads, stream);
}

int eqlb_lu_solve_bm_f32(const void* A, const void* b, void* x, int64_t N,
                         int64_t D, int64_t R, void* stream) {
  return launch_bm<float>(A, b, x, N, D, R, stream);
}

int eqlb_lu_solve_bm_f64(const void* A, const void* b, void* x, int64_t N,
                         int64_t D, int64_t R, void* stream) {
  return launch_bm<double>(A, b, x, N, D, R, stream);
}

int eqlb_lu_solve_bm_reg_f32(const void* A, const void* b, void* x, int64_t N,
                             int64_t D, int64_t R, int64_t mr, int64_t mc,
                             void* stream) {
  return launch_bm_reg<float>(A, b, x, N, D, R, mr, mc, stream);
}

int eqlb_lu_solve_bm_reg_f64(const void* A, const void* b, void* x, int64_t N,
                             int64_t D, int64_t R, int64_t mr, int64_t mc,
                             void* stream) {
  return launch_bm_reg<double>(A, b, x, N, D, R, mr, mc, stream);
}

int eqlb_lu_solve_bm_wide_f32(const void* A, const void* b, void* x,
                              int64_t N, int64_t D, int64_t R, int64_t mr,
                              int64_t mc, void* stream) {
  return launch_bm_wide<float>(A, b, x, N, D, R, mr, mc, stream);
}

int eqlb_lu_solve_bm_wide_f64(const void* A, const void* b, void* x,
                              int64_t N, int64_t D, int64_t R, int64_t mr,
                              int64_t mc, void* stream) {
  return launch_bm_wide<double>(A, b, x, N, D, R, mr, mc, stream);
}

#define EQLB_K3_PAIR(MR, MC) MR, MC,

// writes up to cap values MR0, MC0, MR1, MC1, ... of the built register
// tiles to out and returns the number of tiles
int eqlb_lu_solve_bm_reg_tiles(int64_t* out, int64_t cap) {
  const int64_t tiles[] = {EQLB_K3_REG_TILES(EQLB_K3_PAIR)};
  constexpr int64_t n = sizeof(tiles) / sizeof(tiles[0]);
  for (int64_t e = 0; e < n && e < cap; ++e) out[e] = tiles[e];
  return static_cast<int>(n / 2);
}

// the same for the wide route's tiles
int eqlb_lu_solve_bm_wide_tiles(int64_t* out, int64_t cap) {
  const int64_t tiles[] = {EQLB_K3_WIDE_TILES(EQLB_K3_PAIR)};
  constexpr int64_t n = sizeof(tiles) / sizeof(tiles[0]);
  for (int64_t e = 0; e < n && e < cap; ++e) out[e] = tiles[e];
  return static_cast<int>(n / 2);
}

#undef EQLB_K3_PAIR

}  // extern "C"
