// K3, cluster route: the batch-major pivot-free solve for the systems past
// every tile of one thread block, 128 < D + R <= 256, on a thread-block
// cluster of C CTAs per system.
//
// Replaces the same Pallas entry as the register, wide and shared routes
// of csrc/patch_solve.cu (dolfinx_eqlb_tpu/ops/patch_solve.py::
// batched_kkt_solve, body _kernel): x = A^-1 b for A (N, D, D), b (N, D, R),
// row-major per system, by LU without pivoting, the forward substitution
// fused into the elimination, then back substitution.  The systems are the
// KKT systems of RT4 on unstructured meshes (D = 130 / 156 / 182 / 208 /
// 234, patches of 5-9 cells) and of RT3's 9- and 10-cell patches (D = 135 /
// 150), which the reference pivots (engine.k3_takes stops at D = 110).
//
// What bounds it on the card.  In f64 no SM holds one of these systems:
// [A | b] is 348 KB at D = 208, against 227 KB of shared memory a block and
// 256 KB of registers an SM, and the wide route's 8 x 8 tile (64 values a
// thread on 16 x 16 threads) already takes 255 registers a thread.  Its
// work is ~D^3/3 multiply-adds on ~D^2 values, so as on the wide route the
// time goes with the chain of each elimination step (the pivot, its
// reciprocal, the broadcast of the scaled row, a barrier), D steps a system,
// not with HBM bytes or FP64 operations.  Design:
// - A cluster of C CTAs (2 or 4, grid N C, launched with the cluster
//   dimension attribute) holds one system in registers: each CTA is the wide
//   route's 16 x 16 threads, so the cluster has 16 C thread rows.  Row i of
//   [A | b] belongs to thread row g = i mod 16 C, in CTA g / 16, and to tile
//   row i / 16 C of each of its threads; column c to thread column c mod 16,
//   tile column c / 16.  Each thread keeps its MR x MC values in registers
//   (MR, MC template parameters, loops unrolled so the tile never leaves
//   them): 5 x 10 at C = 2 covers D + R <= 160, 3 x 12 and 4 x 16 at C = 4
//   cover 192 and 256.  Rows in blocks of 16 go round the CTAs, so every
//   CTA keeps live rows to the last steps.
// - Step j: only row j crosses SMs.  Each CTA holds its own rows of column
//   j, so the multipliers stay local (a per-CTA column buffer, as on the
//   wide route).  Row j's owners scale it by the pivot's reciprocal and
//   store it in their CTA's U | y store; then one of them hands it to the
//   copy engine, one bulk copy (cp.async.bulk shared::cta to
//   shared::cluster) into a row slot of each peer, a ring of 8 slots.
// - No cluster-wide barrier in the elimination: each CTA keeps its own pace
//   with one __syncthreads a step, and the rows cross by mbarriers.  A row
//   arrives as transaction bytes on the peer's "full" mbarrier of its slot
//   (the receiver arms it with the row's byte count and waits on it); a
//   slot is written again only after every CTA that read it has arrived on
//   the writer's "empty" mbarrier of that slot.  An owner of 16 consecutive
//   rows so runs ahead of its peers by up to 8 steps, and a transfer's
//   latency lies on the critical path once a block of 16 rows, when the
//   next CTA takes over the pivots, not once a step.  Tried beside it on
//   the H100 in a trial harness not kept (PERF.md section 6 has the
//   times): a split cluster barrier each step after st.shared::cluster
//   stores of the row, the same stores with a release-arrive each on the
//   full mbarrier, and st.async stores counted on it.  The first was 17-39 %
//   slower than the bulk copy at every tile; the other two were level with
//   each other and, against the bulk copy, 3-6 % slower at 2 x 5 x 10, at
//   3 x 12 3 % faster in f64 at D = 182 (level at 156, 3 % slower at 130)
//   but 11-16 % slower in f32, and 21-25 % slower at 4 x 16: value by
//   value, the sending warp waits on the network.
// - A lookahead: at step j the thread row of row j + 1 first applies step
//   j to that row alone, fetches its pivot by a shuffle, scales it and sends
//   it, and the owners of column j + 1 apply step j to that column and store
//   it; the full trailing update then repeats those fmas bit for bit.
//   Every read of step j (row j, the multipliers) goes to registers before
//   the step's barrier, so two column buffers suffice.
// - Shared memory a CTA: its own rows of the scaled [U | y] (16 MR rows at
//   a row stride of whole 16-byte units, as the bulk copy needs: 132 KB at
//   4 x 16 in f64), 8 row slots, two column buffers, two blocks of 16 x
//   values, 16 mbarriers.
// - Back substitution over the cluster, a block of 16 rows at a time from
//   the last: the owner CTA solves its block in one warp (a shuffle a row,
//   y_i -= U_ij x_j for j descending, as the wide route does), writes the 16
//   x values into every CTA and meets a cluster barrier; then every CTA
//   subtracts that block from its own rows above it.  ceil(D / 16) cluster
//   barriers in all, and one before the first block.
// - Cluster barriers at the start (after the mbarriers' init, before any
//   access to a peer's shared memory), between the elimination and the back
//   substitution (so no bulk copy still reads a row of U | y that the back
//   substitution rewrites) and after each block of the back substitution,
//   the last of which every CTA passes after its last remote write: no CTA
//   exits while a peer may still write into it.
// - The launch is checked with cudaOccupancyMaxActiveClusters first: a
//   cluster that cannot be resident is an error, never a quiet fallback.
// Tensor cores (DMMA on a blocked trailing update) and overlapping the next
// system's load are not used.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use
constexpr int kTR = 16, kTC = 16;  // thread rows and columns of a CTA
constexpr int kThreads = kTR * kTC;

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of this CTA's shared variable p in CTA rank
__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_peer(unsigned addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(addr), "d"(v)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive on an mbarrier of any CTA of the cluster (a shared::cluster
// address), releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_at(unsigned addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// arrive on this CTA's mbarrier, expecting `bytes` more of transactions
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) of this
// CTA's shared memory into a peer's, counting them on the peer's mbarrier
__device__ __forceinline__ void bulk_to_peer(unsigned dst, const void* src,
                                             unsigned bytes, unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(mbar)
      : "memory");
}

// wait for the phase of parity `parity` of this CTA's mbarrier to complete
__device__ __forceinline__ void mbar_wait(const uint64_t* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// the register budget: f64 tiles past 36 values take one CTA an SM (255
// registers); f32 tiles and the smaller f64 ones two
template <typename T, int MR, int MC>
constexpr int cluster_min_blocks() {
  return (sizeof(T) == 8 && MR * MC > 36) ? 1 : 2;
}

// row slots a CTA keeps for its peers' rows
constexpr int kSlots = 8;

// row stride of the U | y store and the slots: whole 16-byte units, as a
// bulk copy needs
template <typename T, int MC>
__host__ __device__ constexpr int cluster_ld() {
  return kTC * MC + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int C, int MR, int MC,
          int kMinBlocks = cluster_min_blocks<T, MR, MC>()>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lu_solve_bm_cluster_kernel(const T* __restrict__ A, const T* __restrict__ b,
                           T* __restrict__ x, int D, int R) {
  constexpr int G = kTR * C;       // thread rows of the cluster
  constexpr int kOwn = kTR * MR;   // rows a CTA holds
  constexpr int kLd = cluster_ld<T, MC>();
  // every tile column a step names lies in the tile: qb = j / 16 < MC
  static_assert(C * MR <= MC, "tile");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // row in slot s
  uint64_t* empty = full + kSlots;  // slot s read by every peer
  T* U = reinterpret_cast<T*>(empty + kSlots);  // own rows of [U | y] scaled
  T* slot = U + kOwn * kLd;           // kSlots x kLd: a peer's row j
  T* colbuf = slot + kSlots * kLd;    // 2 x kOwn: own rows of column j
  T* xblk = colbuf + 2 * kOwn;        // 2 x 16 R: a block of x values
  const int W = D + R;
  const int tid = threadIdx.x;
  const int ty = tid / kTC, tx = tid % kTC;
  const int lane0 = tid & 31 & ~(kTC - 1);  // first lane of this thread row
  const unsigned rank = cluster_rank();
  const int64_t p = cluster_id();
  const T* Ap = A + p * D * D;
  const T* bp = b + p * D * R;

  // own row 16 r + ty is row G r + 16 rank + ty of the system
  T a[MR][MC];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int i = G * r + kTR * static_cast<int>(rank) + ty;
#pragma unroll
    for (int q = 0; q < MC; ++q) {
      const int c = tx + kTC * q;
      const T* src = c < D ? Ap + i * D + c : bp + i * R + (c - D);
      a[r][q] = (i < D && c < W) ? *src : T(0);
    }
  }
  unsigned slot_at[C], xblk_at[C], full_at[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    slot_at[k] = peer_addr(slot, k);
    xblk_at[k] = peer_addr(xblk, k);
    full_at[k] = peer_addr(full, k);
  }
  if (tid == 0) {
    for (int e = 0; e < kSlots; ++e) {
      mbar_init(full + e, 1);       // the reader's own expect_tx
      mbar_init(empty + e, C - 1);  // every CTA but the row's owner
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA of the cluster runs before any remote store

  // after the last value of own row `row` is stored, the 16 threads of its
  // thread row hand it, from tile column q0 on, to the copy engine: one
  // bulk copy into slot `sl` of each peer, counted on its full mbarrier
  const unsigned half = 0xffffu << lane0;
  auto send = [&](const T* row, int q0, int sl) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp(half);
    if (tx == 0) {
#pragma unroll
      for (int k = 0; k < C; ++k)
        if (k != static_cast<int>(rank))
          bulk_to_peer(slot_at[k] + (sl * kLd + kTC * q0) * sizeof(T),
                       row + kTC * q0, kTC * (MC - q0) * sizeof(T),
                       full_at[k] + sl * sizeof(uint64_t));
    }
  };

  // row 0 (CTA 0, thread row 0) and column 0, before step 0
  {
    const T piv = __shfl_sync(0xffffffffu, a[0][0], lane0);
    if (rank == 0 && ty == 0) {
      const T inv = T(1) / piv;
#pragma unroll
      for (int q = 0; q < MC; ++q) {
        const int c = tx + kTC * q;
        const T v = c == 0 ? inv : c < W ? a[0][q] * inv : T(0);
        U[c] = v;
      }
      send(U, 0, 0);
    }
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < MR; ++r) colbuf[kTR * r + ty] = a[r][0];
    }
  }
  __syncthreads();
  unsigned fpar = 0, epar = 0;  // phase parities of full[s], empty[s]: bit s

  // step j = G rb + 16 cb + jj: row j is thread row jj of CTA cb, tile row
  // rb; column j is thread column jj, tile column qb = C rb + cb
#pragma unroll
  for (int rb = 0; rb < MR; ++rb) {
#pragma unroll
    for (int cb = 0; cb < C; ++cb) {
      const int qb = C * rb + cb;
      const int rbn = rb + 1 < MR ? rb + 1 : rb;
      const int qbn = qb + 1 < MC ? qb + 1 : qb;
#pragma unroll 1
      for (int jj = 0; jj < kTR; ++jj) {
        const int j = G * rb + kTR * cb + jj;
        if (j >= D) break;
        const int buf = j & 1;
        const int sj = j % kSlots;  // row j's slot
        const bool mine = rank == static_cast<unsigned>(cb);
        if (!mine) {
          // row j's owners sent tile columns qb.. of step j - 1
          if (tid == 0)
            mbar_expect(full + sj, kTC * sizeof(T) *
                                       (MC - (j > 0 ? (j - 1) / kTC : 0)));
          mbar_wait(full + sj, (fpar >> sj) & 1u);
          fpar ^= 1u << sj;
        }
        // row j: from the U | y store in its own CTA, from a slot elsewhere
        const T* urow = mine ? U + (kTR * rb + jj) * kLd : slot + sj * kLd;
        T u[MC], l[MR];
#pragma unroll
        for (int q = qb; q < MC; ++q) u[q] = urow[tx + kTC * q];
#pragma unroll
        for (int r = rb; r < MR; ++r) l[r] = colbuf[buf * kOwn + kTR * r + ty];

        // the lookahead: row j + 1 and column j + 1 after step j.  Past a
        // block of 16 rows, row j + 1 is thread row 0 of the next CTA (of
        // the next tile row after the last CTA), column j + 1 opens the
        // next tile column.
        const int j1 = j + 1;
        const bool edge = jj == kTR - 1;
        const bool down = edge && cb == C - 1;
        const T l1 = down ? l[rbn] : l[rb];
        const T u1 = edge ? u[qbn] : u[qb];
        const T a1 = down ? a[rbn][qbn] : edge ? a[rb][qbn] : a[rb][qb];
        // every thread row fetches its entry in column j + 1; in the thread
        // row of row j + 1 that is the pivot
        const T piv = __shfl_sync(0xffffffffu, fma(-l1, u1, a1),
                                  lane0 | (j1 % kTC));
        const unsigned own1 = edge ? (cb + 1) % C : cb;
        const int s1 = j1 % kSlots;  // row j + 1's slot
        // a slot is written again only once every peer has read its row
        const bool reuse = j1 >= kSlots;
        if (j1 < D && rank == own1 && ty == (edge ? 0 : jj + 1)) {
          if (reuse) mbar_wait(empty + s1, (epar >> s1) & 1u);
          const T inv = T(1) / piv;
          T* row = U + (kTR * (down ? rbn : rb) + ty) * kLd;
#pragma unroll
          for (int q = qb; q < MC; ++q) {
            const int c = tx + kTC * q;
            const T aq = down ? a[rbn][q] : a[rb][q];
            const T v = c == j1 ? inv
                        : (c > j1 && c < W) ? fma(-l1, u[q], aq) * inv
                                            : T(0);
            row[c] = v;
          }
          send(row, qb, s1);
        }
        if (reuse && j1 < D && rank == own1) epar ^= 1u << s1;
        if (j1 < D && tx == j1 % kTC) {
          T* col = colbuf + (buf ^ 1) * kOwn;
#pragma unroll
          for (int r = rb; r < MR; ++r)
            col[kTR * r + ty] = fma(-l[r], u1, edge ? a[r][qbn] : a[r][qb]);
        }
        __syncthreads();
        // slot sj is read: tell the owner of the row that reuses it
        if (!mine && tid == 0 && j + kSlots < D)
          mbar_arrive_at(peer_addr(empty + sj, ((j + kSlots) / kTR) % C));

        // the trailing update; rows and columns behind row j are dead
#pragma unroll
        for (int r = rb; r < MR; ++r) {
#pragma unroll
          for (int q = qb; q < MC; ++q) a[r][q] = fma(-l[r], u[q], a[r][q]);
        }
      }
    }
  }

  // back substitution, blocks of 16 rows from the last.  It writes x into
  // the y column of the U | y store, which the bulk copies of the last rows
  // may still be reading: only a receiver's full mbarrier sees a copy end,
  // and no empty-slot wait covers the rows within kSlots of D.  Every CTA
  // has waited on all of its rows' copies when it reaches this barrier.
  cluster_sync();
  const int nb = (D + kTR - 1) / kTR;
  for (int bk = nb - 1; bk >= 0; --bk) {
    T* xb = xblk + (bk & 1) * kTR * R;
    if (static_cast<unsigned>(bk % C) == rank && tid < 32) {
      const int li = kTR * (bk / C) + (tid & (kTR - 1));
      const int i = kTR * bk + (tid & (kTR - 1));
      const bool mine = tid < kTR && i < D;
      for (int rr = 0; rr < R; ++rr) {
        T y = mine ? U[li * kLd + D + rr] : T(0);
#pragma unroll
        for (int jl = kTR - 1; jl >= 0; --jl) {
          const int j = kTR * bk + jl;
          if (j < D) {
            const T xj = __shfl_sync(0xffffffffu, y, jl);
            if (tid < jl) y = fma(-U[li * kLd + j], xj, y);
          }
        }
        if (mine) {
          U[li * kLd + D + rr] = y;
          const unsigned off = ((bk & 1) * kTR * R + tid * R + rr) * sizeof(T);
#pragma unroll
          for (int k = 0; k < C; ++k) st_peer(xblk_at[k] + off, y);
        }
      }
    }
    cluster_sync();
    // own rows above block bk subtract its x values
    for (int t = tid; t < kOwn * R; t += kThreads) {
      const int li = t / R, rr = t - (t / R) * R;
      const int i = G * (li / kTR) + kTR * static_cast<int>(rank) + li % kTR;
      if (i < kTR * bk) {
        T y = U[li * kLd + D + rr];
        for (int jl = kTR - 1; jl >= 0; --jl) {
          const int j = kTR * bk + jl;
          if (j < D) y = fma(-U[li * kLd + j], xb[jl * R + rr], y);
        }
        U[li * kLd + D + rr] = y;
      }
    }
    __syncthreads();
  }

  T* xp = x + p * D * R;
  for (int t = tid; t < kOwn * R; t += kThreads) {
    const int li = t / R, rr = t - (t / R) * R;
    const int i = G * (li / kTR) + kTR * static_cast<int>(rank) + li % kTR;
    if (i < D) xp[i * R + rr] = U[li * kLd + D + rr];
  }
}

template <typename T, int C, int MR, int MC>
int launch_bm_cluster_tile(const void* A, const void* b, void* x, int64_t N,
                           int64_t D, int64_t R, cudaStream_t stream) {
  constexpr int kOwn = kTR * MR, kLd = cluster_ld<T, MC>();
  if (N <= 0 || N > 0x7fffffff / C || D < 1 || R < 1 ||
      D > kTR * C * MR || D + R > kTC * MC)
    return static_cast<int>(cudaErrorInvalidValue);
  // mbarriers, U | y rows, row slots, column buffers, x blocks: 150 KB at
  // 4 x 16 in f64 and R = 1, at most 215 KB (R = 255)
  const int64_t smem = 2 * kSlots * 8 +
                       (static_cast<int64_t>(kOwn) * kLd + kSlots * kLd +
                        2 * kOwn + 2 * kTR * R) *
                           static_cast<int64_t>(sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lu_solve_bm_cluster_kernel<T, C, MR, MC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(A),
                           static_cast<const T*>(b), static_cast<T*>(x),
                           static_cast<int>(D), static_cast<int>(R));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The tiles (C, MR, MC) built, smallest first: the one list of them in C.
// ops/patch_solve.py::K3_CLUSTER_TILES names the same, and the wrapper holds
// it against eqlb_lu_solve_bm_cluster_tiles before the route's first launch.
#define EQLB_K3_CLUSTER_TILES(X) X(2, 5, 10) X(4, 3, 12) X(4, 4, 16)

template <typename T>
int launch_bm_cluster(const void* A, const void* b, void* x, int64_t N,
                      int64_t D, int64_t R, int64_t c, int64_t mr, int64_t mc,
                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define EQLB_K3_DISPATCH(C, MR, MC)    \
  if (c == C && mr == MR && mc == MC) \
    return launch_bm_cluster_tile<T, C, MR, MC>(A, b, x, N, D, R, s);
  EQLB_K3_CLUSTER_TILES(EQLB_K3_DISPATCH)
#undef EQLB_K3_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int eqlb_lu_solve_bm_cluster_f32(const void* A, const void* b, void* x,
                                 int64_t N, int64_t D, int64_t R, int64_t c,
                                 int64_t mr, int64_t mc, void* stream) {
  return launch_bm_cluster<float>(A, b, x, N, D, R, c, mr, mc, stream);
}

int eqlb_lu_solve_bm_cluster_f64(const void* A, const void* b, void* x,
                                 int64_t N, int64_t D, int64_t R, int64_t c,
                                 int64_t mr, int64_t mc, void* stream) {
  return launch_bm_cluster<double>(A, b, x, N, D, R, c, mr, mc, stream);
}

// writes up to cap values C0, MR0, MC0, C1, ... of the built cluster tiles
// to out and returns the number of tiles
int eqlb_lu_solve_bm_cluster_tiles(int64_t* out, int64_t cap) {
#define EQLB_K3_TRIPLE(C, MR, MC) C, MR, MC,
  const int64_t tiles[] = {EQLB_K3_CLUSTER_TILES(EQLB_K3_TRIPLE)};
#undef EQLB_K3_TRIPLE
  constexpr int64_t n = sizeof(tiles) / sizeof(tiles[0]);
  for (int64_t e = 0; e < n && e < cap; ++e) out[e] = tiles[e];
  return static_cast<int>(n / 3);
}

}  // extern "C"
