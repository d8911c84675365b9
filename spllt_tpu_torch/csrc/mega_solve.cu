// One direction of the triangular solve as one persistent kernel (Hopper,
// sm_90a).
//
// Replaces the TPU kernel spllt_tpu/numeric/solve_mega.py (mega_solve_chunks
// / _kernel / onehot_gather_right).  The sweep is a stream of runs over
// nb-row windows of the work array [P + X, nrhs] (row major: P rows of
// per-node partial-sum panels, then the right-hand side in node-padded
// order); the factor pool [rows, nb] is only read.  Per task the tables
// give the pool window wA, the source window wS, the destination window dst
// and aux; a run has one kind:
//   ADDG  dst[i, :] += src[rel[i], :]  (rel[i] < 0 masks row i)
//   MM    dst -= blk   * src
//   MMT   dst -= blk^T * src
//   SOL   y = m^-1 z,  SOLT  y = m^-T z  with m = blk + I on rows >= aux,
//         z the window wS; y goes back to wS and to dst (its rhs slot).
// ADDG tasks also have the row map rel, and every ADDG / MM / MMT run the
// offsets seg_ptr of its runs of equal dst.
//
// Bound.  Bytes (every factor tile the stream names is read once for
// 2 * nb * nb * nrhs operations) are far below what the sweep takes: a
// sweep is a chain of a few hundred dependent runs near the root, most with
// fewer work items than the card has blocks, so a run lasts one grid
// barrier plus the latency of its slowest item.  The design therefore cuts
// the dependent round trips to device memory inside an item:
//   - every item issues all of its copies at once (cp.async, 16 bytes where
//     the rows line up) instead of a loop of dependent loads;
//   - SOL/SOLT copy only the first kv columns of the tile and substitute in
//     panels of 32 columns: one warp solves a panel's diagonal block in
//     registers with shuffles (no block barrier), then the block applies
//     the panel to the remaining rows in one pass - two block barriers a
//     panel instead of two a column;
//   - MM/MMT stream the tile through a ring of up to four panel slots (the
//     whole float32 tile in flight at once, float64 in two to four slots);
//     each thread owns a fixed block of (row, rhs column) outputs in
//     registers, reads every staged panel once for all rhs columns of the
//     chunk, and the panels are padded so that no warp's shared-memory
//     reads collide in a bank at 1 to 64 rhs columns;
//   - ADDG moves 16-byte vectors, four a thread in flight at once;
//   - a block's first item of a run is its block index (no counter round
//     trip), the next run's header is read before the grid barrier.
// The TPU kernel walks the stream in a sequential grid; blocks here run in
// no order, so ONE cooperative launch per direction loops over the runs,
// the blocks take a run's work items from a counter and a grid barrier at
// each run boundary orders the runs.  Work items, for one chunk of up to
// 64 rhs columns:
//   ADDG  one destination segment, or several consecutive ones where a
//         segment's vectors fill at most half the block: the tasks' rows
//         are summed in task order in registers, the destination read and
//         written once;
//   MM / MMT  one destination segment and one band of up to 128
//         destination rows (32 or 64 in a run with few segments, as the
//         stream's run_split says): summed over the segment's tasks in
//         registers;
//   SOL / SOLT  one tile (in a run with few tiles, chunks of 16 or 32 rhs
//         columns), its result written to both places.
// Every item sums in a fixed order, whichever block takes it, so the
// result does not depend on the number of blocks; no floating-point
// atomics.  The work array is written and read inside the launch, so it
// is read through L2 (cp.async.cg, ld.global.cg) or, for element copies,
// only after the grid barrier that orders the write.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace spllt;
namespace coop = cooperative_groups;

constexpr int KIND_ADDG = 0, KIND_MM = 1, KIND_MMT = 2, KIND_SOL = 3,
              KIND_SOLT = 4;
constexpr int NT = 256, NWARP = NT / 32;
constexpr int kChunk = 64;     // most rhs columns of one work item
constexpr int kBand = 128;     // most destination rows of one MM/MMT item
constexpr int kPanel = 32;     // factor columns of one substitution panel
constexpr int kStagesMax = 4;  // slots of the MM/MMT panel ring
constexpr int kAddgUnroll = 4; // ADDG vectors in flight per thread

struct Stream {
  const int* run_ptr;    // [nruns + 1] first task of each run
  const int* run_kind;   // [nruns]
  const int* run_seg;    // [nruns + 1] ADD runs: their slice of seg_ptr
  const int* run_rel;    // [nruns] ADDG runs: first task minus first rel row
  const int* run_split;  // [nruns] 1, 2, 4: MM/MMT bands of kBand / split
                         // rows, SOL/SOLT chunks of max(16, kChunk / split)
  const int* seg_ptr;    // per ADD run nseg + 1 task offsets
  const int* wa;
  const int* ws;
  const int* dst;
  const int* aux;
  const int* rel;        // [ADDG tasks, nb]
  int* counters;         // [nruns] zero at launch: next work item of a run
  int nruns;
};

// Sizes fixed at launch (host and device).
struct Layout {
  int nb, nrhs, zcap;
  int zvec;      // work rows line up for 16-byte copies (nrhs * size % 16)
  int pvec;      // pool rows line up for 16-byte copies (nb * size % 16)
  int sol_in;    // SOL/SOLT stage the tile in shared memory
  int ldm;       // row stride of the staged SOL tile
  int rcs_sol;   // row stride of the staged SOL rhs chunk
  int pw;        // MM/MMT panel width (contraction): 128 bytes of a row
  int band;      // MM/MMT staged destination rows, min(nb, kBand)
  int lda, ldb;  // MM / MMT panel row strides
  int zoff;      // offset of the rhs rows inside a ring slot
  int slot;      // elements of one ring slot
  int stages;
};

// ------------------------------------------------------------------ //
// asynchronous copies
// ------------------------------------------------------------------ //
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes through L2 only (coherent with other SMs' writes)
__device__ __forceinline__ void cp16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(s)),
               "l"(g)
               : "memory");
}
// one element (4 or 8 bytes)
template <typename T>
__device__ __forceinline__ void cp_elem(T* s, const T* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, nr) x columns [0, nc) of a row-major source (row stride
// lds elements) to shared memory (row stride ldd); 16-byte copies when vec
// (then nc, lds, ldd and both bases are multiples of 16 bytes).
template <typename T>
__device__ __forceinline__ void copy_rows(T* d, int ldd, const T* s,
                                          size_t lds, int nr, int nc,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = nc / V;
    for (int e = tid; e < nr * cpr; e += NT) {
      const int i = e / cpr, q = e - i * cpr;
      cp16(d + i * ldd + q * V, s + i * lds + q * V);
    }
  } else {
    for (int e = tid; e < nr * nc; e += NT) {
      const int i = e / nc, c = e - i * nc;
      cp_elem(d + i * ldd + c, s + i * lds + c);
    }
  }
}

template <typename T>
struct Vec16 {   // 16 bytes
  using type = typename std::conditional<sizeof(T) == 4, float4,
                                         double2>::type;
};

// ------------------------------------------------------------------ //
// ADDG: dst[i, c] += sum_t src_t[rel_t[i], c], tasks in order
// ------------------------------------------------------------------ //
template <typename T, typename VT>
__device__ __forceinline__ void add_to(VT& a, const VT& b) {
  constexpr int V = sizeof(VT) / sizeof(T);
  T* pa = reinterpret_cast<T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int q = 0; q < V; ++q) pa[q] += pb[q];
}

// Segments [sg, sg + ns) of seg_ptr (absolute indices), rhs columns
// [c0, c0 + rc), in vectors of V elements: vector e of the item belongs to
// segment e / (nb * cv), its row and column group are the rest.  Every
// vector sums its tasks in task order.
template <typename T, typename VT>
__device__ __forceinline__ void addg_item(T* work, const Stream& s,
                                          const Layout& L, int shift, int sg,
                                          int ns, int c0, int rc, int tid) {
  constexpr int V = sizeof(VT) / sizeof(T), U = kAddgUnroll;
  const int nb = L.nb, nrhs = L.nrhs;
  const int cv = rc / V, per = nb * cv, total = ns * per;
  for (int base = 0; base < total; base += NT * U) {
    VT acc[U];
    int a0[U], len[U], row[U], col[U];
    T* d[U];
    int most = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + tid + u * NT;
      a0[u] = len[u] = row[u] = col[u] = 0;
      d[u] = work;
      if (e < total) {
        const int so = e / per, rem = e - so * per;
        row[u] = rem / cv;
        col[u] = c0 + (rem - row[u] * cv) * V;
        a0[u] = __ldg(s.seg_ptr + sg + so);
        len[u] = __ldg(s.seg_ptr + sg + so + 1) - a0[u];
        d[u] = work + ((size_t)__ldg(s.dst + a0[u]) + row[u]) * nrhs +
               col[u];
        acc[u] = __ldcg(reinterpret_cast<const VT*>(d[u]));
        most = max(most, len[u]);
      }
    }
    for (int k = 0; k < most; ++k) {
      int rv[U];
      const T* src[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        rv[u] = -1;
        src[u] = work;
        if (k < len[u]) {
          const int t = a0[u] + k;
          rv[u] = __ldg(s.rel + (size_t)(t - shift) * nb + row[u]);
          src[u] = work + (size_t)__ldg(s.ws + t) * nrhs + col[u];
        }
      }
      VT sv[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (rv[u] >= 0)
          sv[u] = __ldcg(
              reinterpret_cast<const VT*>(src[u] + (size_t)rv[u] * nrhs));
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (rv[u] >= 0) add_to<T>(acc[u], sv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + tid + u * NT < total)
        *reinterpret_cast<VT*>(d[u]) = acc[u];
  }
}

// ------------------------------------------------------------------ //
// MM / MMT: dst[band] -= sum_t op(blk_t)[band, :] * src_t over a segment
// ------------------------------------------------------------------ //
// Panel p of a task: contraction range [p * pw, p * pw + pw).  MM stages
// blk[band rows, p cols] as A[r][k] (stride lda), MMT blk[p rows, band
// cols] as B[k][r] (stride ldb); both stage the source rows p as Z[k][c]
// (stride rcs) at offset zoff of the slot.  tile / src: the task's pool
// tile and source window (at column c0).
template <typename T, bool TRANS>
__device__ __forceinline__ void mm_issue(const T* tile, const T* src,
                                         const Layout& L, int p, int band0,
                                         int bn, int rc, int rcs, T* slot,
                                         int tid) {
  const int nb = L.nb, k0 = p * L.pw;
  const int kn = min(L.pw, nb - k0);
  if (TRANS)
    copy_rows(slot, L.ldb, tile + (size_t)k0 * nb + band0, nb, kn, bn,
              L.pvec, tid);
  else
    copy_rows(slot, L.lda, tile + (size_t)band0 * nb + k0, nb, bn, kn,
              L.pvec, tid);
  copy_rows(slot + L.zoff, rcs, src + (size_t)k0 * L.nrhs, L.nrhs, kn, rc,
            L.zvec, tid);
}

// The outputs of an item: column groups of 4, padded to a power of two
// cg2; a warp holds WC groups x SK contraction slices x 8 rows, the block's
// warps CB column blocks x WRG row groups, each thread RPT rows x 4 columns
// (RPT = 16 / WRG: 2, 4 or 8).
template <typename T, bool TRANS, int RPT>
__device__ __forceinline__ void mm_body(const T* __restrict__ pool, T* work,
                                        const Stream& s, const Layout& L,
                                        int a0, int a1, int c0, int rc,
                                        int cg2, int band0, int bn, T* sm,
                                        int tid) {
  const int nb = L.nb, nrhs = L.nrhs, np = (nb + L.pw - 1) / L.pw;
  const int total = (a1 - a0) * np;
  const int WC = cg2 < 4 ? cg2 : 4, SK = 4 / WC, CB = cg2 / WC;
  const int WRG = NWARP / CB;
  const int rcs = 4 * cg2, lda = L.lda, ldb = L.ldb, zoff = L.zoff;
  const int lane = tid & 31, warp = tid >> 5;
  const int wc = lane % WC, sl = (lane / WC) % SK, lr = lane >> 2;
  const int col = 4 * ((warp % CB) * WC + wc), wrg = warp / CB;

  T acc[RPT][4];
  int roff[RPT];                     // the rows' offsets in a staged panel
  bool rok[RPT];
  T* d = work + ((size_t)s.dst[a0] + band0) * nrhs + c0;
#pragma unroll
  for (int rb = 0; rb < RPT; ++rb) {
    const int r = (rb * WRG + wrg) * 8 + lr;
    rok[rb] = r < bn;
    roff[rb] = TRANS ? r : r * lda;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[rb][q] = (sl == 0 && rok[rb] && col + q < rc)
                       ? __ldcg(d + (size_t)r * nrhs + col + q)
                       : T(0);
  }

  // the panels in flight belong to task it (pointers read once a task)
  const int S = L.stages;
  int it = -1;
  const T* tile = nullptr;
  const T* src = nullptr;
  auto issue = [&](int g) {
    if (g < total) {
      if (g / np != it) {
        it = g / np;
        tile = pool + (size_t)__ldg(s.wa + a0 + it) * nb;
        src = work + (size_t)__ldg(s.ws + a0 + it) * nrhs + c0;
      }
      mm_issue<T, TRANS>(tile, src, L, g % np, band0, bn, rc, rcs,
                         sm + (g % S) * L.slot, tid);
    }
    cp_commit();
  };
  for (int g = 0; g < S - 1; ++g) issue(g);
  for (int g = 0; g < total; ++g) {
    issue(g + S - 1);
    // the group of panel g is complete once at most S - 1 newer ones wait
    if (S == 4) cp_wait<3>();
    else if (S == 3) cp_wait<2>();
    else cp_wait<1>();
    __syncthreads();
    const T* A = sm + (g % S) * L.slot;
    const T* Z = A + zoff + col;
    const int kn = min(L.pw, nb - (g % np) * L.pw);
    for (int k = sl; k < kn; k += SK) {
      T z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) z[q] = Z[k * rcs + q];
      const T* Ak = TRANS ? A + k * ldb : A + k;
#pragma unroll
      for (int rb = 0; rb < RPT; ++rb) {
        const T a = rok[rb] ? Ak[roff[rb]] : T(0);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rb][q] -= a * z[q];
      }
    }
    __syncthreads();   // slot g % S is refilled by the next iteration
  }
  cp_wait<0>();

  // sum the contraction slices (lanes WC and 2 * WC apart), in a fixed
  // order: both partners of a butterfly step add the same two values
  for (int off = WC; off < 4; off <<= 1)
#pragma unroll
    for (int rb = 0; rb < RPT; ++rb)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[rb][q] += __shfl_xor_sync(kFull, acc[rb][q], off);
  if (sl == 0) {
#pragma unroll
    for (int rb = 0; rb < RPT; ++rb) {
      const int r = (rb * WRG + wrg) * 8 + lr;
      if (rok[rb])
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < rc) d[(size_t)r * nrhs + col + q] = acc[rb][q];
    }
  }
}

// destination rows [band0, band0 + bn) (bn <= kBand) of one segment
template <typename T, bool TRANS>
__device__ __forceinline__ void mm_item(const T* __restrict__ pool, T* work,
                                        const Stream& s, const Layout& L,
                                        int a0, int a1, int c0, int rc,
                                        int band0, int bn, T* sm, int tid) {
  int cg2 = 1;
  while (4 * cg2 < rc) cg2 <<= 1;
  if (cg2 <= 4)
    mm_body<T, TRANS, 2>(pool, work, s, L, a0, a1, c0, rc, cg2, band0, bn,
                         sm, tid);
  else if (cg2 == 8)
    mm_body<T, TRANS, 4>(pool, work, s, L, a0, a1, c0, rc, cg2, band0, bn,
                         sm, tid);
  else
    mm_body<T, TRANS, 8>(pool, work, s, L, a0, a1, c0, rc, cg2, band0, bn,
                         sm, tid);
}

// ------------------------------------------------------------------ //
// SOL / SOLT: blocked substitution in one tile
// ------------------------------------------------------------------ //
// m: the tile's rows (stride ldm), its first kv columns valid; zs: the rhs
// chunk [nb, rcs].  m = tile + I on the rows >= kv.
//   forward:   per panel of <= 32 columns, warp w solves the panel's
//              diagonal block for columns w, w + nw, ... (lane = row,
//              shuffles), then the block subtracts the panel from every
//              row below it (rows >= kv included: their identity diagonal
//              makes y_i = z_i - m[i, :kv] y).
//   transpose: rows >= kv pass through; they are first folded into the
//              rows < kv, then the panels are solved from the last one up,
//              each subtracted from the rows above it.
// Warp `warp` of the nw column owners solves the panel's diagonal block for
// its columns warp, warp + nw, ... (at most CW of them): lane l holds row l
// of the block (forward) or column l (transpose) in registers, and the
// reciprocal of its diagonal entry; one shuffle a column and step.
template <typename T, int CW>
__device__ __forceinline__ void panel_diag_warp(const T* m, int ldm, T* zs,
                                                int rcs, int j0, int pb,
                                                int rc, int nw,
                                                bool transpose, int lane,
                                                int warp) {
  T mv[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j)
    mv[j] = (lane < pb && j < pb)
                ? (transpose ? m[(j0 + j) * ldm + j0 + lane]
                             : m[(j0 + lane) * ldm + j0 + j])
                : T(0);
  const T rinv = lane < pb ? T(1) / m[(j0 + lane) * ldm + j0 + lane] : T(1);
  T z[CW];
#pragma unroll
  for (int q = 0; q < CW; ++q) {
    const int c = warp + q * nw;
    z[q] = (lane < pb && c < rc) ? zs[(j0 + lane) * rcs + c] : T(0);
  }
  if (!transpose) {
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      if (j < pb) {
#pragma unroll
        for (int q = 0; q < CW; ++q) {
          if (lane == j) z[q] *= rinv;
          const T y = __shfl_sync(kFull, z[q], j);
          if (lane > j) z[q] -= mv[j] * y;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = kPanel - 1; j >= 0; --j) {
      if (j < pb) {
#pragma unroll
        for (int q = 0; q < CW; ++q) {
          if (lane == j) z[q] *= rinv;
          const T y = __shfl_sync(kFull, z[q], j);
          if (lane < j) z[q] -= mv[j] * y;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CW; ++q) {
    const int c = warp + q * nw;
    if (lane < pb && c < rc) zs[(j0 + lane) * rcs + c] = z[q];
  }
}

template <typename T>
__device__ __forceinline__ void panel_diag(const T* m, int ldm, T* zs,
                                           int rcs, int j0, int pb, int rc,
                                           bool transpose, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = rc < NWARP ? rc : NWARP;
  if (warp >= nw) return;
  const int cw = (rc + nw - 1) / nw;
  if (cw == 1)
    panel_diag_warp<T, 1>(m, ldm, zs, rcs, j0, pb, rc, nw, transpose, lane,
                          warp);
  else if (cw == 2)
    panel_diag_warp<T, 2>(m, ldm, zs, rcs, j0, pb, rc, nw, transpose, lane,
                          warp);
  else if (cw <= 4)
    panel_diag_warp<T, 4>(m, ldm, zs, rcs, j0, pb, rc, nw, transpose, lane,
                          warp);
  else
    panel_diag_warp<T, kChunk / NWARP>(m, ldm, zs, rcs, j0, pb, rc, nw,
                                       transpose, lane, warp);
}

// rows [r0, r1) of zs -= (forward) m[i, j0:j0+pb] * zs[j0:j0+pb] or
// (transpose) m[j0:j0+pb, i]^T * zs[j0:j0+pb]; an item is one row and 4
// columns, and where there are few items, sp neighbouring lanes share one
// item's contraction and sum it with shuffles (a fixed order)
template <typename T>
__device__ __forceinline__ void panel_apply(const T* m, int ldm, T* zs,
                                            int rcs, int j0, int pb, int r0,
                                            int r1, int rc, bool transpose,
                                            int tid) {
  const int cq = (rc + 3) >> 2;
  const int items = (r1 - r0) * cq;
  int sp = 1;
  while (sp < 32 && items * sp * 2 <= NT && sp * 2 <= pb) sp <<= 1;
  const int part = tid & (sp - 1);
  for (int e0 = 0; e0 < items * sp; e0 += NT) {   // uniform in the block
    const int e = (e0 + tid) / sp;
    const bool live = e < items;
    const int i = r0 + (live ? e / cq : 0), c = live ? 4 * (e % cq) : 0;
    T a[4] = {T(0), T(0), T(0), T(0)};
    if (live) {
      for (int j = part; j < pb; j += sp) {
        const T mij =
            transpose ? m[(j0 + j) * ldm + i] : m[i * ldm + j0 + j];
        const T* y = zs + (j0 + j) * rcs + c;
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] += mij * y[q];
      }
    }
    for (int off = 1; off < sp; off <<= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] += __shfl_xor_sync(kFull, a[q], off);
    if (live && part == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q) zs[i * rcs + c + q] -= a[q];
  }
}

template <typename T>
__device__ __forceinline__ void sol_item(const T* __restrict__ pool,
                                         T* work, const Stream& s,
                                         const Layout& L, int t, int c0,
                                         int rc, bool transpose, T* sm,
                                         int tid) {
  const int nb = L.nb, nrhs = L.nrhs, rcs = L.rcs_sol;
  const int kv = __ldg(s.aux + t);
  T* z = work + (size_t)__ldg(s.ws + t) * nrhs + c0;
  T* y1 = work + (size_t)__ldg(s.dst + t) * nrhs + c0;
  const T* tile = pool + (size_t)__ldg(s.wa + t) * nb;
  T* zs = sm;
  const T* m = tile;
  int ldm = nb;
  copy_rows(zs, rcs, (const T*)z, nrhs, nb, rc, L.zvec, tid);
  if (L.sol_in) {
    T* ms = sm + (size_t)nb * rcs;
    constexpr int V = 16 / sizeof(T);
    const int kc = L.pvec ? (kv + V - 1) / V * V : kv;   // <= nb
    copy_rows(ms, L.ldm, tile, nb, nb, kc, L.pvec, tid);
    m = ms;
    ldm = L.ldm;
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  if (!transpose) {
    for (int j0 = 0; j0 < kv; j0 += kPanel) {
      const int pb = min(kPanel, kv - j0);
      panel_diag(m, ldm, zs, rcs, j0, pb, rc, false, tid);
      __syncthreads();
      if (j0 + pb < nb) {
        panel_apply(m, ldm, zs, rcs, j0, pb, j0 + pb, nb, rc, false, tid);
        __syncthreads();
      }
    }
  } else {
    if (kv > 0 && kv < nb) {
      // fold the pass-through rows >= kv into the rows < kv
      panel_apply(m, ldm, zs, rcs, kv, nb - kv, 0, kv, rc, true, tid);
      __syncthreads();
    }
    for (int j0 = (kv - 1) / kPanel * kPanel; kv > 0 && j0 >= 0;
         j0 -= kPanel) {
      const int pb = min(kPanel, kv - j0);
      panel_diag(m, ldm, zs, rcs, j0, pb, rc, true, tid);
      __syncthreads();
      if (j0 > 0) {
        panel_apply(m, ldm, zs, rcs, j0, pb, 0, j0, rc, true, tid);
        __syncthreads();
      }
    }
  }

  // y to the source window and to the rhs slot
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec16<T>::type;
  if (L.zvec) {
    const int cv = rc / V;
    for (int e = tid; e < nb * cv; e += NT) {
      const int i = e / cv, q = e - i * cv;
      const VT v = *reinterpret_cast<const VT*>(zs + i * rcs + q * V);
      *reinterpret_cast<VT*>(z + (size_t)i * nrhs + q * V) = v;
      *reinterpret_cast<VT*>(y1 + (size_t)i * nrhs + q * V) = v;
    }
  } else {
    for (int e = tid; e < nb * rc; e += NT) {
      const int i = e / rc, c = e - i * rc;
      z[(size_t)i * nrhs + c] = zs[i * rcs + c];
      y1[(size_t)i * nrhs + c] = zs[i * rcs + c];
    }
  }
}

// ------------------------------------------------------------------ //
// the stream
// ------------------------------------------------------------------ //
// A block's first item of a run is its block index; the next ones come
// from the run's counter.  The leading barrier keeps the shared memory and
// *slot from being reused while a thread is still in the previous item.
__device__ __forceinline__ int claim(int* counter, int* slot, int tid) {
  __syncthreads();
  if (tid == 0) *slot = (int)gridDim.x + atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

struct RunHead {
  int kind, t0, t1, sg0, sg1, shift, split;
};

__device__ __forceinline__ RunHead run_head(const Stream& s, int r) {
  RunHead h{};
  h.kind = -1;
  if (r < s.nruns) {
    h.kind = __ldg(s.run_kind + r);
    h.t0 = __ldg(s.run_ptr + r);
    h.t1 = __ldg(s.run_ptr + r + 1);
    h.sg0 = __ldg(s.run_seg + r);
    h.sg1 = __ldg(s.run_seg + r + 1);
    h.shift = __ldg(s.run_rel + r);
    h.split = __ldg(s.run_split + r);
  }
  return h;
}

// How the run loop cuts a run into work items (all derived from its head).
struct RunItems {
  int n;       // work items
  int group;   // ADDG: segments an item
  int band;    // MM/MMT: destination rows an item
  int cw;      // SOL/SOLT: rhs columns an item; ADDG/MM/MMT: kChunk
  int nch;     // rhs chunks
  int nband;   // MM/MMT: bands a segment
};

template <typename T>
__device__ __forceinline__ RunItems run_items(const RunHead& h,
                                              const Layout& L) {
  constexpr int V = 16 / sizeof(T);
  RunItems it{0, 1, kBand, kChunk, (L.nrhs + kChunk - 1) / kChunk, 1};
  const int nseg = h.sg1 - h.sg0 - 1;
  if (h.kind == KIND_ADDG) {
    // where a segment's vectors fill at most half the block, an item is
    // several consecutive segments (one claim, one group of threads each)
    it.group = max(1, NT / (L.nb * (L.zvec ? L.zcap / V : L.zcap)));
    it.n = (nseg + it.group - 1) / it.group * it.nch;
  } else if (h.kind == KIND_MM || h.kind == KIND_MMT) {
    // a run with few segments cuts them into bands of fewer rows
    it.band = kBand / h.split;
    it.nband = (L.nb + it.band - 1) / it.band;
    it.n = nseg * it.nch * it.nband;
  } else if (h.kind == KIND_SOL || h.kind == KIND_SOLT) {
    // a run with few tiles cuts the rhs into narrower chunks
    it.cw = max(16, kChunk / h.split);
    it.nch = (L.nrhs + it.cw - 1) / it.cw;
    it.n = (h.t1 - h.t0) * it.nch;
  }
  return it;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
mega_solve_kernel(const T* __restrict__ pool, T* work, Stream s, Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int slot;
  T* sm = reinterpret_cast<T*>(smem_raw);
  coop::grid_group grid = coop::this_grid();
  const int tid = threadIdx.x;
  using VT = typename Vec16<T>::type;

  RunHead h = run_head(s, 0);
  for (int r = 0; r < s.nruns; ++r) {
    const RunItems it = run_items<T>(h, L);
    const int nseg = h.sg1 - h.sg0 - 1;
    for (int item = blockIdx.x; item < it.n;
         item = claim(s.counters + r, &slot, tid)) {
      if (h.kind == KIND_ADDG) {
        const int g0 = (item / it.nch) * it.group;
        const int c0 = (item % it.nch) * kChunk;
        const int rc = min(kChunk, L.nrhs - c0);
        const int ns = min(it.group, nseg - g0);
        if (L.zvec)
          addg_item<T, VT>(work, s, L, h.shift, h.sg0 + g0, ns, c0, rc, tid);
        else
          addg_item<T, T>(work, s, L, h.shift, h.sg0 + g0, ns, c0, rc, tid);
      } else if (h.kind == KIND_MM || h.kind == KIND_MMT) {
        const int seg = item / (it.nch * it.nband);
        const int rest = item - seg * it.nch * it.nband;
        const int c0 = (rest / it.nband) * kChunk;
        const int band0 = (rest % it.nband) * it.band;
        const int rc = min(kChunk, L.nrhs - c0);
        const int bn = min(it.band, L.nb - band0);
        const int a0 = __ldg(s.seg_ptr + h.sg0 + seg);
        const int a1 = __ldg(s.seg_ptr + h.sg0 + seg + 1);
        if (h.kind == KIND_MM)
          mm_item<T, false>(pool, work, s, L, a0, a1, c0, rc, band0, bn, sm,
                            tid);
        else
          mm_item<T, true>(pool, work, s, L, a0, a1, c0, rc, band0, bn, sm,
                           tid);
      } else {
        const int t = h.t0 + item / it.nch;
        const int c0 = (item % it.nch) * it.cw;
        sol_item<T>(pool, work, s, L, t, c0, min(it.cw, L.nrhs - c0),
                    h.kind == KIND_SOLT, sm, tid);
      }
    }
    h = run_head(s, r + 1);   // read before the barrier, used after it
    grid.sync();
  }
}

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename T>
int launch(const void* pool, void* work, const int* run_ptr,
           const int* run_kind, const int* run_seg, const int* run_rel,
           const int* run_split, const int* seg_ptr, const int* wa,
           const int* ws, const int* dst,
           const int* aux, const int* rel, int* counters, int nruns, int nb,
           int nrhs, int max_blocks, int* grid_out, void* stream) {
  if (grid_out) *grid_out = 0;
  if (nruns <= 0 || nrhs <= 0) return 0;
  Stream s{run_ptr, run_kind, run_seg, run_rel, run_split, seg_ptr,
           wa,      ws,       dst,     aux,     rel,       counters,
           nruns};
  constexpr int sz = (int)sizeof(T), V = 16 / sz;
  Layout L{};
  L.nb = nb;
  L.nrhs = nrhs;
  L.zcap = nrhs < kChunk ? nrhs : kChunk;
  L.zvec = (nrhs * sz) % 16 == 0;
  L.pvec = (nb * sz) % 16 == 0;
  L.rcs_sol = (L.zcap + 3) / 4 * 4;
  L.ldm = nb + V;
  const size_t sol_z = (size_t)nb * L.rcs_sol * sz;
  const size_t sol_tile = (size_t)nb * L.ldm * sz;
  L.sol_in = sol_z + sol_tile <= (size_t)kMaxSmem;
  const size_t sol = sol_z + (L.sol_in ? sol_tile : 0);
  L.pw = 128 / sz;
  L.band = nb < kBand ? nb : kBand;
  L.lda = L.pw + V;
  L.ldb = L.band + 2 * V;
  const int a_elems = (L.band * L.lda > L.pw * L.ldb ? L.band * L.lda
                                                     : L.pw * L.ldb);
  L.zoff = (a_elems + 3) / 4 * 4;
  const int rcs_mm = 4 * pow2_at_least((L.zcap + 3) / 4);
  L.slot = L.zoff + (L.pw * rcs_mm + 3) / 4 * 4;
  // as many ring slots as fit beside the SOL stage without dropping below
  // two blocks an SM (or one, where the SOL stage needs that anyway)
  const size_t cap = sol > (size_t)kHalfSmem ? sol : (size_t)kHalfSmem;
  L.stages = kStagesMax;
  while (L.stages > 2 && (size_t)L.stages * L.slot * sz > cap) --L.stages;
  size_t smem = (size_t)L.stages * L.slot * sz;
  if (sol > smem) smem = sol;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const T* pool_t = (const T*)pool;
  T* work_t = (T*)work;
  void* args[] = {&pool_t, &work_t, &s, &L};
  return launch_cooperative(mega_solve_kernel<T>, NT, smem, max_blocks,
                            grid_out, args, stream);
}

}  // namespace

#define SPLLT_MEGA_SOLVE_ARGS                                               \
  const void *pool, void *work, const int *run_ptr, const int *run_kind,    \
      const int *run_seg, const int *run_rel, const int *run_split,         \
      const int *seg_ptr,                                                   \
      const int *wa, const int *ws, const int *dst, const int *aux,         \
      const int *rel, int *counters, int nruns, int nb, int nrhs,           \
      int max_blocks, int *grid_out, void *stream

// counters: nruns ints, zero.  max_blocks > 0 caps the grid (for tests of
// the item loops); grid_out receives the number of blocks launched.
extern "C" int spllt_mega_solve_f32(SPLLT_MEGA_SOLVE_ARGS) {
  return launch<float>(pool, work, run_ptr, run_kind, run_seg, run_rel,
                       run_split, seg_ptr, wa, ws, dst, aux, rel, counters,
                       nruns, nb, nrhs, max_blocks, grid_out, stream);
}
extern "C" int spllt_mega_solve_f64(SPLLT_MEGA_SOLVE_ARGS) {
  return launch<double>(pool, work, run_ptr, run_kind, run_seg, run_rel,
                        run_split, seg_ptr, wa, ws, dst, aux, rel, counters,
                        nruns, nb, nrhs, max_blocks, grid_out, stream);
}
