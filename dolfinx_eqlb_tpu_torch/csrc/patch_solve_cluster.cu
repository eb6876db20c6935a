// K3, cluster route: the batch-major pivot-free solve for the systems past
// every tile of one thread block of the wide route, 128 < D + R <= 256.
//
// Replaces the same Pallas entry as the register, wide and shared routes
// of csrc/patch_solve.cu (dolfinx_eqlb_tpu/ops/patch_solve.py::
// batched_kkt_solve, body _kernel): x = A^-1 b for A (N, D, D), b (N, D, R),
// row-major per system, by LU without pivoting in the given [sigma | r]
// order, the forward substitution fused into the elimination, then back
// substitution.  The systems are the KKT systems of RT4 on unstructured
// meshes (D = 130 / 156 / 182 / 208 / 234, patches of 5-9 cells) and of
// RT3's 9- and 10-cell patches (D = 135 / 150), which the reference pivots
// (its size rule stops at D = 110).  Two kernels, by dtype; the tiles of
// both are one list (EQLB_K3_CLUSTER_TILES, below).
//
// What bounds the route.  Its work is ~2 D^3 / 3 operations on ~D^2
// values: ~330 GFLOP and ~24 GB a call of the RT4 cell, 5 ms at 67 TFLOP/s
// of FP64 tensor cores and 7.3 ms at 3.35 TB/s.  What bounded it before
// the blocked kernel was neither: the elimination ran D strictly serial
// rank-1 steps a system, each a pivot, a reciprocal, a barrier and one row
// crossing SMs, ~1,100-2,100 cycles a step against ~150 of the step's
// FMAs, with 132 / C systems in flight (1.4-3.1 % of the bound, PERF.md).
// So the serial chain, not the transport of a row, has to shrink.
//
// f64, lu_solve_bm_cluster_blocked_kernel: a right-looking blocked LU of
// panel width kNb = 16, the trailing update on the FP64 tensor cores.
// - A cluster of C CTAs (C = 1, 2 or 4) holds one system in shared memory:
//   row block g (rows 16 g .. 16 g + 15) lives in CTA g mod C, its rows at
//   a stride of 16 NC + 4 values (column 16 NC holds 1 / pivot; the stride
//   is 4 mod 16, so the DMMA fragments below load without bank conflicts,
//   and a row is whole 16-byte units for the bulk copies).  Tiles (C, MB,
//   NC): MB row blocks a CTA, 16 NC columns; D <= 16 C MB, D + R <= 16 NC.
// - C follows from D: where [A | b] fits one CTA's 227 KB (1 x 10 x 10,
//   D + R <= 160 at R = 1: RT4's D = 130 / 156, RT3's 135 / 150) no row
//   crosses SMs and a system takes one SM; past it 2 x 6 x 12 (D + R <=
//   192: D = 182) and 4 x 4 x 16 (to 256: D = 208 / 234) spread the rows.
// - Panel k: the owner of row block k factors its 16 x 16 diagonal block
//   in one warp (a lane a column, the multipliers by shuffle; the same
//   divisions in the same order as the scalar elimination), then forms
//   U12 | y, the block's columns past the panel, a thread a column.  With
//   C > 1 it hands the block to the copy engine, one bulk copy a row into
//   a slot of each peer, counted on the peer's mbarrier: one transfer and
//   one wait a panel, D / 16 a system instead of D.  Every CTA then forms
//   L21 = A21 U11^-1 for its own rows below the panel (a thread a row) and
//   applies A22 -= L21 U12 (b's columns with it) on DMMA, mma.sync
//   m8n8k4 f64: a warp a 16 x 16 block of A22, 16 products of 8 x 8 x 4.
// - A lookahead: the owner of row block k + 1 updates that block first,
//   factors it and sends it, then updates its other rows, so its peers
//   find block k + 1 waiting when they finish panel k.  Two slots a CTA;
//   a cluster barrier split in two (arrive after a panel, wait before the
//   next send) keeps a slot from being written while a peer still reads
//   it.  At C = 1 nothing waits on a send: warp 0 factors the diagonal
//   of block k + 1 while the other warps update the rows below it, and
//   its U12 | y is formed with the next panel's L21, three barriers a
//   panel.
// - Back substitution a row block at a time from the last: the owner
//   solves the block's triangle in one warp (a shuffle a row), hands the
//   16 x values to every CTA (C > 1: into the free slots), and every CTA
//   subtracts them from its own rows above.
// - The kernel allocates nothing; the load is cp.async into shared
//   memory, zero past row D and column D + R.  A launch that cannot be
//   resident is an error: C > 1 is checked with
//   cudaOccupancyMaxActiveClusters first, never a quiet fallback.
//
// f32, lu_solve_bm_cluster_kernel: the scalar-step kernel, kept because a
// full-precision f32 product has no tensor-core form (TF32 would lower the
// precision).  A cluster of C CTAs of the wide route's 16 x 16 threads
// holds one system in registers, a tile of MR x MC values a thread (rows
// in blocks of 16 go round the CTAs), and runs D rank-1 steps: at step j
// only row j crosses SMs, scaled by its owner and handed to the copy
// engine as one bulk copy into a ring of 8 row slots of each peer, counted
// on mbarriers, so each CTA keeps its own pace with one __syncthreads a
// step; a lookahead sends row j + 1 and stores column j + 1 before step j's
// trailing update.  (Its transport was tried against a cluster barrier a
// step, st.shared::cluster stores and st.async stores: all level or slower,
// PERF.md section 6.)  Its back substitution goes a block of 16 rows at a
// time as the blocked kernel's does.


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

// row slots a CTA keeps for its peers' rows
constexpr int kSlots = 8;

// row stride of the U | y store and the slots: whole 16-byte units, as a
// bulk copy needs
template <typename T, int MC>
__host__ __device__ constexpr int cluster_ld() {
  return kTC * MC + 16 / static_cast<int>(sizeof(T));
}

// f32 (the kernel is written for any T): two CTAs an SM, up to 128
// registers a thread
template <typename T, int C, int MR, int MC>
__global__ void __launch_bounds__(kThreads, 2)
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
  // mbarriers, U | y rows, row slots, column buffers, x blocks: 75 KB at
  // 4 x 16 in f32 and R = 1, at most 108 KB (R = 255)
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


// ---------------------------------------------------------------------------
// f64: the blocked LU, trailing updates on DMMA

constexpr int kNb = 16;  // panel width, rows of a row block
constexpr int kBThreads = 512;
constexpr int kBWarps = kBThreads / 32;

// row stride of a CTA's rows, in values: 16 NC columns of [A | b], the
// reciprocal of the row's pivot, padding to 4 mod 16
template <int NC>
__host__ __device__ constexpr int blocked_ld() {
  return kNb * NC + 4;
}

// two mbarriers, the CTA's MB row blocks and, with peers, two row-block
// slots
template <int C, int MB, int NC>
constexpr int64_t blocked_smem() {
  return 16 + static_cast<int64_t>(kNb * MB + (C > 1 ? 2 * kNb : 0)) *
                  blocked_ld<NC>() * 8;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// 8 bytes from global into shared memory, zero where bytes is 0
__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          unsigned bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d += a b for one 8 x 8 x 4 product on the FP64 tensor cores: a is
// A[lane / 4][lane % 4], b is B[lane % 4][lane / 4], d holds
// D[lane / 4][2 (lane % 4) + 0, 1]
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

template <int C, int MB, int NC>
__global__ void __launch_bounds__(kBThreads, 1)
lu_solve_bm_cluster_blocked_kernel(const double* __restrict__ A,
                                   const double* __restrict__ b,
                                   double* __restrict__ x, int D, int R) {
  constexpr int kLd = blocked_ld<NC>();
  constexpr int kCols = kNb * NC;  // column kCols of a row: 1 / its pivot
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // slot s has arrived
  double* M = reinterpret_cast<double*>(smem + 16);  // own row blocks
  double* slot = M + kNb * MB * kLd;  // C > 1: 2 x 16 rows, a peer's block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = C > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int64_t p = C > 1 ? static_cast<int64_t>(cluster_id())
                          : static_cast<int64_t>(blockIdx.x);
  const int W = D + R;
  const int nrb = (D + kNb - 1) / kNb;  // row blocks of the system
  const int cend = (W + kNb - 1) / kNb * kNb;  // columns the updates sweep
  // own local block lb is row block lb C + rank; those past D hold nothing
  const int lbe = min(MB, (nrb - rank + C - 1) / C);

  {  // own rows of [A | b], zero past row D and column W
    const double* Ap = A + p * D * D;
    const double* bp = b + p * D * R;
    for (int t = tid; t < kNb * MB * kCols; t += kBThreads) {
      const int li = t / kCols, c = t - li * kCols;
      const int i = kNb * ((li / kNb) * C + rank) + li % kNb;
      const double* src = Ap;
      unsigned bytes = 0;
      if (i < D && c < W) {
        src = c < D ? Ap + static_cast<int64_t>(i) * D + c
                    : bp + static_cast<int64_t>(i) * R + (c - D);
        bytes = 8;
      }
      cp_async8(M + li * kLd + c, src, bytes);
    }
  }
  unsigned slot_at[C], full_at[C];
  if constexpr (C > 1) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      slot_at[q] = peer_addr(slot, q);
      full_at[q] = peer_addr(full, q);
    }
    if (tid == 0) {
      mbar_init(full, 1);  // the receiver's own expect_tx
      mbar_init(full + 1, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (C > 1) cluster_sync();  // peers run before a remote write

  // the owner of row block k, warp 0: its 16 x 16 diagonal block into
  // L11 \ U11 and 1 / pivot
  auto diag = [&](int k) {
    double* Rk = M + kNb * (k / C) * kLd;
    const int c0 = kNb * k, nbk = min(kNb, D - c0);
    const int cl = lane & (kNb - 1);
    double v[kNb];
#pragma unroll
    for (int ii = 0; ii < kNb; ++ii) v[ii] = Rk[ii * kLd + c0 + cl];
#pragma unroll
    for (int jj = 0; jj < kNb; ++jj) {
      if (jj < nbk) {
        const double r = 1.0 / __shfl_sync(0xffffffffu, v[jj], jj);
        if (lane == jj) Rk[jj * kLd + kCols] = r;
#pragma unroll
        for (int ii = jj + 1; ii < kNb; ++ii) {
          const double l = __shfl_sync(0xffffffffu, v[ii], jj) * r;
          v[ii] = cl == jj ? l : cl > jj ? fma(-l, v[jj], v[ii]) : v[ii];
        }
      }
    }
    if (lane < kNb) {
#pragma unroll
      for (int ii = 0; ii < kNb; ++ii) Rk[ii * kLd + c0 + cl] = v[ii];
    }
  };

  // column c of row block k's U12 | y: L11^-1 applied, a thread a column
  auto upper = [&](int k, int c) {
    double* Rk = M + kNb * (k / C) * kLd;
    const int c0 = kNb * k, nbk = min(kNb, D - c0);
    double u[kNb];
#pragma unroll
    for (int ii = 0; ii < kNb; ++ii) u[ii] = Rk[ii * kLd + c];
#pragma unroll
    for (int jj = 0; jj < kNb; ++jj) {
      if (jj < nbk) {
#pragma unroll
        for (int ii = jj + 1; ii < kNb; ++ii)
          u[ii] = fma(-Rk[ii * kLd + c0 + jj], u[jj], u[ii]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < kNb; ++ii) Rk[ii * kLd + c] = u[ii];
  };

  // C > 1, the owner of row block k: the block's diagonal and U12 | y,
  // then the block to each peer's slot k & 1, a bulk copy a row from
  // column 16 k on
  auto factor_send = [&](int k) {
    const int c0 = kNb * k;
    if (warp == 0) diag(k);
    __syncthreads();
    for (int c = c0 + kNb + tid; c < cend; c += kBThreads) upper(k, c);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid < kNb) {
      const int s = k & 1;
      const unsigned off = ((s * kNb + tid) * kLd + c0) * 8;
      const double* row = M + (kNb * (k / C) + tid) * kLd + c0;
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (q != rank)
          bulk_to_peer(slot_at[q] + off, row, (kLd - c0) * 8,
                       full_at[q] + s * 8);
    }
  };

  // own row li of L21 = A21 U11^-1 in place, a thread a row; U is row
  // block k (Ub: its row 0, columns as in M)
  auto lower = [&](int k, const double* Ub, int li) {
    const int c0 = kNb * k;
    double2* row = reinterpret_cast<double2*>(M + li * kLd + c0);
    double a[kNb];
#pragma unroll
    for (int h = 0; h < kNb / 2; ++h) {
      const double2 v = row[h];
      a[2 * h] = v.x;
      a[2 * h + 1] = v.y;
    }
#pragma unroll
    for (int jj = 0; jj < kNb; ++jj) {
      a[jj] *= Ub[jj * kLd + kCols];
#pragma unroll
      for (int m = jj + 1; m < kNb; ++m)
        a[m] = fma(-a[jj], Ub[jj * kLd + c0 + m], a[m]);
    }
#pragma unroll
    for (int h = 0; h < kNb / 2; ++h)
      row[h] = make_double2(a[2 * h], a[2 * h + 1]);
  };

  // A22 -= L21 U12 on own rows of local blocks [lb0, lb1), columns past
  // panel k to cend, by warps w0 .. kBWarps - 1: a warp a 16 x 16 block,
  // four 8 x 8 tiles, each the sum of four 8 x 8 x 4 products
  auto update = [&](int k, const double* Ub, int lb0, int lb1, int w0) {
    const int c0 = kNb * k;
    const int ncg = (cend - c0) / kNb - 1;
    const int r4 = lane >> 2, q4 = lane & 3;
    if (warp < w0) return;
    for (int t = warp - w0; t < (lb1 - lb0) * ncg; t += kBWarps - w0) {
      const int cg = c0 + kNb * (1 + t % ncg);
      double* Mb = M + kNb * (lb0 + t / ncg) * kLd;
      double a[2][4], u[4][2], acc[2][2][2];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          a[rt][ks] = -Mb[(8 * rt + r4) * kLd + c0 + 4 * ks + q4];
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int ct = 0; ct < 2; ++ct)
          u[ks][ct] = Ub[(4 * ks + q4) * kLd + cg + 8 * ct + r4];
      }
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
        for (int ct = 0; ct < 2; ++ct) {
          const double2 v = *reinterpret_cast<const double2*>(
              Mb + (8 * rt + r4) * kLd + cg + 8 * ct + 2 * q4);
          acc[rt][ct][0] = v.x;
          acc[rt][ct][1] = v.y;
        }
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
          for (int ct = 0; ct < 2; ++ct)
            dmma(acc[rt][ct], a[rt][ks], u[ks][ct]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
        for (int ct = 0; ct < 2; ++ct)
          *reinterpret_cast<double2*>(Mb + (8 * rt + r4) * kLd + cg + 8 * ct +
                                      2 * q4) =
              make_double2(acc[rt][ct][0], acc[rt][ct][1]);
      }
    }
  };

  // Panel k.  C = 1: U12 | y of row block k is formed together with L21;
  // after row block k + 1 is updated, warp 0 factors its diagonal while
  // the other warps update the rows below it.  C > 1: the owner of row
  // block k + 1 updates, factors and sends it before its other rows.
  if (rank == 0) {
    if constexpr (C > 1) {
      factor_send(0);
    } else {
      if (warp == 0) diag(0);
      __syncthreads();
    }
  }
  if constexpr (C > 1) cluster_arrive();
  unsigned fpar = 0;  // phase parity of full[s]: bit s
  for (int k = 0; k < nrb; ++k) {
    const double* Ub = M + kNb * (k / C) * kLd;
    if (k % C != rank) {  // row block k from its owner, in slot k & 1
      const int s = k & 1;
      if (tid == 0) mbar_expect(full + s, kNb * (kLd - kNb * k) * 8);
      mbar_wait(full + s, (fpar >> s) & 1u);
      fpar ^= 1u << s;
      Ub = slot + s * kNb * kLd;
    }
    const int lb0 = (k + C - rank) / C;  // own blocks past row block k
    const int ncol = C > 1 ? 0 : cend - kNb * (k + 1);
    for (int t = tid; t < ncol + kNb * (lbe - lb0); t += kBThreads) {
      if (t < ncol)
        upper(k, kNb * (k + 1) + t);
      else
        lower(k, Ub, kNb * lb0 + t - ncol);
    }
    __syncthreads();
    // every CTA is past panel k - 1, so no peer reads slot (k + 1) & 1
    if constexpr (C > 1) cluster_wait();
    int lb = lb0, w0 = 0;
    if (k + 1 < nrb && (k + 1) % C == rank) {  // the lookahead
      update(k, Ub, lb0, lb0 + 1, 0);
      __syncthreads();
      if constexpr (C > 1) {
        factor_send(k + 1);
      } else if (warp == 0) {
        diag(k + 1);
      }
      ++lb;
      w0 = C > 1 ? 0 : 1;
    }
    update(k, Ub, lb, lbe, w0);
    __syncthreads();
    if constexpr (C > 1) cluster_arrive();
  }
  if constexpr (C > 1) cluster_wait();

  // back substitution; the x values of row block bk are read from its y
  // columns (C = 1) or from slot bk & 1 of every CTA, 16 x R
  for (int bk = nrb - 1; bk >= 0; --bk) {
    const int c0 = kNb * bk, nbk = min(kNb, D - c0);
    double* Rb = M + kNb * (bk / C) * kLd;
    if (bk % C == rank && warp == 0) {
      for (int rr = 0; rr < R; ++rr) {
        double y = lane < nbk ? Rb[lane * kLd + D + rr] : 0.0;
#pragma unroll
        for (int jl = kNb - 1; jl >= 0; --jl) {
          if (jl < nbk) {
            if (lane == jl) y *= Rb[jl * kLd + kCols];
            const double xj = __shfl_sync(0xffffffffu, y, jl);
            if (lane < jl) y = fma(-Rb[lane * kLd + c0 + jl], xj, y);
          }
        }
        if (lane < nbk) {
          Rb[lane * kLd + D + rr] = y;
          if constexpr (C > 1) {
            const unsigned off = ((bk & 1) * kNb * kLd + lane * R + rr) * 8;
#pragma unroll
            for (int q = 0; q < C; ++q) st_peer(slot_at[q] + off, y);
          }
        }
      }
    }
    if constexpr (C > 1) cluster_sync(); else __syncthreads();
    const double* xs = C > 1 ? slot + (bk & 1) * kNb * kLd : Rb + D;
    const int xld = C > 1 ? R : kLd;
    const int lbb = (bk - rank + C - 1) / C;  // own blocks above bk
    for (int t = tid; t < kNb * lbb * R; t += kBThreads) {
      const int li = t / R, rr = t - li * R;
      double* row = M + li * kLd;
      double y = row[D + rr];
      for (int jl = 0; jl < nbk; ++jl)
        y = fma(-row[c0 + jl], xs[jl * xld + rr], y);
      row[D + rr] = y;
    }
    __syncthreads();
  }

  double* xp = x + p * D * R;
  for (int t = tid; t < kNb * lbe * R; t += kBThreads) {
    const int li = t / R, rr = t - li * R;
    const int i = kNb * ((li / kNb) * C + rank) + li % kNb;
    if (i < D) xp[i * R + rr] = M[li * kLd + D + rr];
  }
}

template <int C, int MB, int NC>
int launch_bm_blocked_tile(const void* A, const void* b, void* x, int64_t N,
                           int64_t D, int64_t R, cudaStream_t stream) {
  constexpr int64_t smem = blocked_smem<C, MB, NC>();
  static_assert(smem <= kMaxSmem, "a tile's rows exceed shared memory");
  if (N <= 0 || N > 0x7fffffff / C || D < 1 || R < 1 ||
      D > kNb * C * MB || D + R > kNb * NC)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lu_solve_bm_cluster_blocked_kernel<C, MB, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N * C));
  cfg.blockDim = dim3(kBThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  if (C > 1) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const double*>(A),
                           static_cast<const double*>(b),
                           static_cast<double*>(x), static_cast<int>(D),
                           static_cast<int>(R));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The tiles built, smallest first by dtype, (bytes of a value, C, MR, MC):
// the one list of them in C.  f32: the scalar-step kernel's (C, MR, MC);
// f64: the blocked kernel's (C, MB, NC).  ops/patch_solve.py::
// K3_CLUSTER_TILES names the same, and the wrapper holds it against
// eqlb_lu_solve_bm_cluster_tiles before the route's first launch.
#define EQLB_K3_CLUSTER_TILES(X)                          \
  X(4, 2, 5, 10) X(4, 4, 3, 12) X(4, 4, 4, 16)            \
  X(8, 1, 10, 10) X(8, 2, 6, 12) X(8, 4, 4, 16)

template <typename T, int C, int MR, int MC>
int launch_cluster_tile(const void* A, const void* b, void* x, int64_t N,
                        int64_t D, int64_t R, cudaStream_t stream) {
  if constexpr (sizeof(T) == 8)
    return launch_bm_blocked_tile<C, MR, MC>(A, b, x, N, D, R, stream);
  else
    return launch_bm_cluster_tile<T, C, MR, MC>(A, b, x, N, D, R, stream);
}

template <typename T>
int launch_bm_cluster(const void* A, const void* b, void* x, int64_t N,
                      int64_t D, int64_t R, int64_t c, int64_t mr, int64_t mc,
                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define EQLB_K3_DISPATCH(BYTES, C, MR, MC)                                 \
  if constexpr (sizeof(T) == BYTES) {                                      \
    if (c == C && mr == MR && mc == MC)                                    \
      return launch_cluster_tile<T, C, MR, MC>(A, b, x, N, D, R, s);       \
  }
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

// writes up to cap values BYTES0, C0, MR0, MC0, BYTES1, ... of the built
// cluster tiles to out and returns the number of tiles
int eqlb_lu_solve_bm_cluster_tiles(int64_t* out, int64_t cap) {
#define EQLB_K3_QUAD(BYTES, C, MR, MC) BYTES, C, MR, MC,
  const int64_t tiles[] = {EQLB_K3_CLUSTER_TILES(EQLB_K3_QUAD)};
#undef EQLB_K3_QUAD
  constexpr int64_t n = sizeof(tiles) / sizeof(tiles[0]);
  for (int64_t e = 0; e < n && e < cap; ++e) out[e] = tiles[e];
  return static_cast<int>(n / 4);
}

}  // extern "C"
