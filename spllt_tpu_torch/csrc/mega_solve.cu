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
// Bound: bytes - every factor tile the stream names is read once for
// 2 * nb * nb * nrhs operations - and, on the narrow levels near the root,
// the chain of dependent runs (one grid barrier each).  The TPU kernel
// walks the stream in a sequential grid with double-buffered window copies,
// first/last flags around each destination group and drain flags at run
// boundaries; blocks here run in no order, so ONE cooperative launch per
// direction loops over the runs, the blocks take a run's work items from a
// counter (whichever block is free takes the next one) and a grid barrier
// at each run boundary takes the place of the drain.  Work items, each for one chunk of up to 64 rhs columns:
//   ADDG / MM / MMT  one destination segment: the tasks' contributions are
//          summed (registers / shared memory) and the destination window is
//          read and written once - deterministic, no atomics.  MM walks the
//          tile by rows (a warp per row, lanes along the contraction, a
//          shuffle reduction), MMT by columns (a thread per output), so
//          both read the tile in neighbouring words.
//   SOL / SOLT  one tile: the in-window substitution of solve_body.cuh,
//          writing its result to both places.
// work is read and written through an ordinary pointer (a run reads what
// an earlier run of the same launch wrote); only the pool, which the
// kernel never writes, is const __restrict__.
#include <cooperative_groups.h>

#include "solve_body.cuh"

namespace {

using namespace spllt;
namespace coop = cooperative_groups;

constexpr int KIND_ADDG = 0, KIND_MM = 1, KIND_MMT = 2, KIND_SOL = 3,
              KIND_SOLT = 4;
constexpr int NT = 256;

struct Stream {
  const int* run_ptr;    // [nruns + 1] first task of each run
  const int* run_kind;   // [nruns]
  const int* run_seg;    // [nruns + 1] ADD runs: their slice of seg_ptr
  const int* run_rel;    // [nruns] ADDG runs: first task minus first rel row
  const int* seg_ptr;    // per ADD run nseg + 1 task offsets
  const int* wa;
  const int* ws;
  const int* dst;
  const int* aux;
  const int* rel;        // [ADDG tasks, nb]
  int* counters;         // [nruns] zero at launch: next work item of a run
  int nruns;
};

// dst[i, c] += sum_t src_t[rel_t[i], c] over the segment's tasks
template <typename T>
__device__ __forceinline__ void addg_segment(T* work, const Stream& s,
                                             int shift, int a0, int a1,
                                             int nb, int nrhs, int c0, int rc,
                                             int tid) {
  T* d = work + (size_t)s.dst[a0] * nrhs + c0;
  for (int e = tid; e < nb * rc; e += NT) {
    const int i = e / rc, c = e - i * rc;
    T acc = T(0);
    for (int t = a0; t < a1; ++t) {
      const int rel = s.rel[(size_t)(t - shift) * nb + i];
      if (rel >= 0) acc += work[((size_t)s.ws[t] + rel) * nrhs + c0 + c];
    }
    d[(size_t)i * nrhs + c] += acc;
  }
}

// dst -= sum_t op(blk_t) * src_t over the segment's tasks; op = transpose
// when TRANS.  zs [nb, rc] stages a task's source window, accs [nb, rc]
// holds the sum; every entry of accs belongs to one thread (MMT) or to one
// warp's lane 0 (MM) throughout.
template <typename T, bool TRANS>
__device__ __forceinline__ void mm_segment(const T* __restrict__ pool,
                                           T* work, const Stream& s, int a0,
                                           int a1, int nb, int nrhs, int c0,
                                           int rc, int zcap,
                                           unsigned char* smem_raw, int tid) {
  T* zs = reinterpret_cast<T*>(smem_raw);
  T* accs = zs + (size_t)nb * zcap;
  const int lane = tid & 31, warp = tid >> 5, nwarp = NT >> 5;
  for (int e = tid; e < nb * rc; e += NT) accs[e] = T(0);
  for (int t = a0; t < a1; ++t) {
    __syncthreads();     // the previous task's reads of zs are done
    const T* src = work + (size_t)s.ws[t] * nrhs + c0;
    for (int e = tid; e < nb * rc; e += NT) {
      const int i = e / rc, c = e - i * rc;
      zs[e] = src[(size_t)i * nrhs + c];
    }
    __syncthreads();
    const T* blk = pool + (size_t)s.wa[t] * nb;
    if (TRANS) {
      // out[k, c] = sum_i blk[i, k] * z[i, c]: neighbouring threads read
      // neighbouring k
      for (int e = tid; e < nb * rc; e += NT) {
        const int c = e / nb, k = e - c * nb;
        T a = T(0);
        for (int i = 0; i < nb; ++i) a += blk[(size_t)i * nb + k] * zs[i * rc + c];
        accs[k * rc + c] += a;
      }
    } else {
      // out[i, c] = sum_k blk[i, k] * z[k, c]: a warp per row i, its lanes
      // along k, four columns at a time
      for (int i = warp; i < nb; i += nwarp) {
        const T* row = blk + (size_t)i * nb;
        for (int cc = 0; cc < rc; cc += 4) {
          T p[4] = {T(0), T(0), T(0), T(0)};
          for (int k = lane; k < nb; k += 32) {
            const T b = row[k];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (cc + q < rc) p[q] += b * zs[k * rc + cc + q];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              p[q] += __shfl_xor_sync(kFull, p[q], off);
            if (lane == 0 && cc + q < rc) accs[i * rc + cc + q] += p[q];
          }
        }
      }
    }
  }
  __syncthreads();
  T* d = work + (size_t)s.dst[a0] * nrhs + c0;
  for (int e = tid; e < nb * rc; e += NT) {
    const int i = e / rc, c = e - i * rc;
    d[(size_t)i * nrhs + c] -= accs[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
mega_solve_kernel(const T* __restrict__ pool, T* work, Stream s, int nb,
                  int nrhs, int sol_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int slot;
  coop::grid_group grid = coop::this_grid();
  const int tid = threadIdx.x;
  const int nchunk = (nrhs + kRhsChunk - 1) / kRhsChunk;
  const int zcap = min(kRhsChunk, nrhs);

  for (int r = 0; r < s.nruns; ++r) {
    const int kind = s.run_kind[r];
    const int t0 = s.run_ptr[r], n = s.run_ptr[r + 1] - t0;
    if (kind <= KIND_MMT) {
      const int sg0 = s.run_seg[r];
      const int nseg = s.run_seg[r + 1] - sg0 - 1;
      const int shift = s.run_rel[r];
      for (int item; (item = next_item(s.counters + r, &slot, tid)) <
                     nseg * nchunk;) {
        const int seg = item / nchunk, c0 = (item % nchunk) * kRhsChunk;
        const int rc = min(kRhsChunk, nrhs - c0);
        const int a0 = s.seg_ptr[sg0 + seg], a1 = s.seg_ptr[sg0 + seg + 1];
        if (kind == KIND_ADDG)
          addg_segment<T>(work, s, shift, a0, a1, nb, nrhs, c0, rc, tid);
        else if (kind == KIND_MM)
          mm_segment<T, false>(pool, work, s, a0, a1, nb, nrhs, c0, rc, zcap,
                               smem_raw, tid);
        else
          mm_segment<T, true>(pool, work, s, a0, a1, nb, nrhs, c0, rc, zcap,
                              smem_raw, tid);
      }
    } else if (kind == KIND_SOL || kind == KIND_SOLT) {
      for (int item; (item = next_item(s.counters + r, &slot, tid)) <
                     n * nchunk;) {
        const int t = t0 + item / nchunk, c0 = (item % nchunk) * kRhsChunk;
        T* z = work + (size_t)s.ws[t] * nrhs + c0;
        left_solve_tile<T>(pool + (size_t)s.wa[t] * nb, z, z,
                           work + (size_t)s.dst[t] * nrhs + c0, s.aux[t], nb,
                           min(kRhsChunk, nrhs - c0), nrhs, zcap,
                           kind == KIND_SOLT, sol_in_smem, smem_raw, tid, NT);
      }
    }
    grid.sync();
  }
}

template <typename T>
int launch(const void* pool, void* work, const int* run_ptr,
           const int* run_kind, const int* run_seg, const int* run_rel,
           const int* seg_ptr, const int* wa, const int* ws, const int* dst,
           const int* aux, const int* rel, int* counters, int nruns, int nb,
           int nrhs, int max_blocks, int* grid_out, void* stream) {
  if (grid_out) *grid_out = 0;
  if (nruns <= 0 || nrhs <= 0) return 0;
  Stream s{run_ptr, run_kind, run_seg, run_rel,  seg_ptr, wa,
           ws,      dst,      aux,     rel,      counters, nruns};
  const int zcap = nrhs < kRhsChunk ? nrhs : kRhsChunk;
  int sol_in = left_solve_smem<T>(nb, zcap, true) <= (size_t)kMaxSmem;
  size_t smem = left_solve_smem<T>(nb, zcap, sol_in);
  const size_t mm = 2 * (size_t)nb * zcap * sizeof(T);   // zs + accs
  if (mm > smem) smem = mm;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const T* pool_t = (const T*)pool;
  T* work_t = (T*)work;
  void* args[] = {&pool_t, &work_t, &s, &nb, &nrhs, &sol_in};
  return launch_cooperative(mega_solve_kernel<T>, NT, smem, max_blocks,
                            grid_out, args, stream);
}

}  // namespace

#define SPLLT_MEGA_SOLVE_ARGS                                               \
  const void *pool, void *work, const int *run_ptr, const int *run_kind,    \
      const int *run_seg, const int *run_rel, const int *seg_ptr,           \
      const int *wa, const int *ws, const int *dst, const int *aux,         \
      const int *rel, int *counters, int nruns, int nb, int nrhs,           \
      int max_blocks, int *grid_out, void *stream

// counters: nruns ints, zero.  max_blocks > 0 caps the grid (for tests of
// the item loops); grid_out receives the number of blocks launched.
extern "C" int spllt_mega_solve_f32(SPLLT_MEGA_SOLVE_ARGS) {
  return launch<float>(pool, work, run_ptr, run_kind, run_seg, run_rel,
                       seg_ptr, wa, ws, dst, aux, rel, counters, nruns, nb,
                       nrhs, max_blocks, grid_out, stream);
}
extern "C" int spllt_mega_solve_f64(SPLLT_MEGA_SOLVE_ARGS) {
  return launch<double>(pool, work, run_ptr, run_kind, run_seg, run_rel,
                        seg_ptr, wa, ws, dst, aux, rel, counters, nruns, nb,
                        nrhs, max_blocks, grid_out, stream);
}
