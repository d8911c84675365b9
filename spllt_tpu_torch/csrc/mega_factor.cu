// The whole numeric factorization as one stream of persistent launches
// (Hopper, sm_90a).
//
// Replaces the TPU kernel spllt_tpu/numeric/megakernel.py (mega_factorize /
// _kernel).  The factorization is a stream of runs in dependency order: per
// level of the plan a run of UPD tasks (between-node update micro-tasks and
// the within-node syrk/gemm products as identity-map tasks, sorted by
// destination), then a run of POTRF tasks, then a run of TRSM tasks, all in
// place on the flat pool [rows, nb].  Per task the tables give two window
// row bases wr / wc, the destination row base dst, aux (UPD: the valid
// columns blkn of the destination; POTRF / TRSM: the factor column count
// kv) and srcn (UPD: the valid width of the source block column); UPD tasks
// also have the window-relative row maps relr / relc, and every UPD run the
// offsets seg_ptr of its runs of equal dst.
//
// Bound: the sum of its bodies' bounds (bytes for the sparse update tasks
// and the leaf potrf tiles, the dependent chains of potrf and trsm on the
// narrow top levels) plus one grid barrier per run.  Most POTRF and TRSM
// runs near the root have fewer items than the card has blocks, so such a
// run lasts one grid barrier plus the latency of its slowest item; their
// bodies (mega_factor_body.cuh, this kernel's own) are built to cut that
// latency, and a TRSM run with few pairs cuts them into bands of fewer rows
// (run_split) so that more blocks share the run.  The TPU kernel walks
// the stream in a sequential grid, one group of tasks per step, with
// double-buffered window copies, a carried accumulator and drain flags at
// the run boundaries; blocks here run in no order, so instead a
// cooperative launch of as many blocks as fit the card loops over a part
// of the runs, the blocks take a run's work items from a counter
// (whichever block is free takes the next one), and a grid barrier at each
// run boundary takes the place of the drain.  The runs go in parts of one
// kind, UPD runs or POTRF and TRSM runs, one launch each (two a level),
// each part in a kernel that holds only its own bodies: the update body
// uses every register a float kernel may have, and the POTRF/TRSM bodies
// in the same kernel made the UPD runs 9-50 % slower.  Work items:
//   UPD    one destination segment (piece): its tasks are summed in
//          registers and the destination is read and written once
//          (update_body.cuh) - deterministic, no atomics;
//   POTRF  one tile, in place on the pool (mega_factor_body.cuh);
//   TRSM   64 / run_split[r] rows of one (diag, dst) pair, in place
//          (mega_factor_body.cuh).
// A block's first POTRF or TRSM item of a run is its block index.
// There is no gathered copy of tiles in or out.  The pool is read and
// written through an ordinary pointer everywhere: a run reads what an
// earlier run wrote, which the grid barrier (or the launch boundary)
// orders for ordinary loads and for cp.async.cg (through L2), but not for
// the read-only path nor for cp.async.ca.  All launches use 256 threads a
// block; the host keeps each kernel's shared memory under half an SM's
// where the tiles allow, so that two blocks share an SM.
#include <cooperative_groups.h>

#include <algorithm>

#include "mega_factor_body.cuh"
#include "update_body.cuh"

namespace {

using namespace spllt;
namespace coop = cooperative_groups;

constexpr int KIND_UPD = 0, KIND_POTRF = 1, KIND_TRSM = 2;
constexpr int NT = kUpdNT;

struct Stream {
  const int* run_ptr;    // [nruns + 1] first task of each run
  const int* run_kind;   // [nruns]
  const int* run_seg;    // [nruns + 1] UPD runs: their slice of seg_ptr
  const int* run_rel;    // [nruns] UPD runs: first task minus first rel row
  const int* run_split;  // [nruns] TRSM runs: items of kTrsmItemRows / split
                         // dst rows (1, 2 or 4)
  const int* seg_ptr;    // per UPD run nseg + 1 task offsets
  const int* wr;
  const int* wc;
  const int* dst;
  const int* aux;
  const int* srcn;
  const int* relr;       // [UPD tasks, nb]
  const int* relc;
  int* counters;         // [nruns] zero at launch: next work item of a run
  int nruns;
};

// A block's first item of a run is its block index; the next ones come
// from the run's counter.  The leading barrier keeps the shared memory and
// *slot from being reused while a thread is still in the previous item.
__device__ __forceinline__ int claim(int* counter, int* slot, int tid) {
  __syncthreads();
  if (tid == 0) *slot = (int)gridDim.x + atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

// The two kernels of the stream.  Runs [r0, r1) of one part: UPD runs
// (FAC false) or POTRF and TRSM runs (FAC true), a grid barrier between
// consecutive runs; the launch boundary orders one part before the next.
// Each kernel carries only its own bodies: the update body sits at the
// register cap of a float kernel, and any other body in the same kernel
// changes its register allocation (measured: UPD runs 9-50 % slower).
// IN: the POTRF tile and the TRSM factor fit in shared memory.  Float
// kernels are held to the registers that let two blocks share an SM.
template <typename T, int TM, bool FAC, bool IN>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
mega_factor_kernel(T* pool, Stream s, int nb, int trsm_rows, int r0,
                   int r1) {
  __shared__ int slot;
  coop::grid_group grid = coop::this_grid();
  constexpr int BM = 16 * TM;
  const int tid = threadIdx.x;
  const int npc = (nb + BM - 1) / BM;      // pieces of a tile, per side

  for (int r = r0; r < r1; ++r) {
    const int kind = s.run_kind[r];
    const int t0 = s.run_ptr[r], n = s.run_ptr[r + 1] - t0;
    if (!FAC) {
      const int sg0 = s.run_seg[r];
      const int nseg = s.run_seg[r + 1] - sg0 - 1;
      const int shift = s.run_rel[r];
      auto& sm = *reinterpret_cast<UpdSmem<T, TM, TM>*>(fac_smem);
      for (int item; (item = next_item(s.counters + r, &slot, tid)) <
                     nseg * npc * npc;) {
        const int seg = item / (npc * npc), pc = item % (npc * npc);
        const int a0 = s.seg_ptr[sg0 + seg], a1 = s.seg_ptr[sg0 + seg + 1];
        update_segment<T, TM, TM>(pool, s.wr, s.wc, s.aux, s.srcn, s.relr,
                                  s.relc, shift, (long long)s.dst[a0], nb, a0,
                                  a1, (pc / npc) * BM, (pc % npc) * BM, sm,
                                  tid);
      }
    } else if (kind == KIND_POTRF) {
      for (int item = blockIdx.x; item < n;
           item = claim(s.counters + r, &slot, tid)) {
        const int t = t0 + item;
        fac_potrf_item<T, IN>(pool + (size_t)s.dst[t] * nb, s.aux[t], nb,
                              tid);
      }
    } else if (kind == KIND_TRSM) {
      const int ri = kTrsmItemRows / s.run_split[r];
      const int nrb = (nb + ri - 1) / ri;   // row bands of a pair
      for (int item = blockIdx.x; item < n * nrb;
           item = claim(s.counters + r, &slot, tid)) {
        const int t = t0 + item / nrb, b0 = (item % nrb) * ri;
        fac_trsm_item<T, IN>(pool + (size_t)s.wr[t] * nb,
                             pool + (size_t)s.dst[t] * nb, s.aux[t], nb, b0,
                             min(ri, nb - b0), trsm_rows, tid);
      }
    }
    if (r + 1 < r1) grid.sync();
  }
}

// Where the POTRF tile and the TRSM factor live, the dst rows a TRSM item
// stages at once and the shared memory of the POTRF/TRSM kernel: both in
// shared memory within half an SM (two blocks an SM) or else within a
// whole block's allowance; where they do not fit there, POTRF works in
// place on the pool and TRSM stages L^T a panel at a time, within half an
// SM.  (Each budget leaves a margin for the kernel's static shared
// memory.)
struct FacConfig {
  bool in;
  int rows;
  size_t smem;
};

template <typename T>
FacConfig fac_config(int nb) {
  const int rows0 = nb < kTrsmItemRows ? nb : kTrsmItemRows;
  const size_t budgets[2] = {(size_t)kHalfSmem - 64, (size_t)kMaxSmem - 64};
  for (size_t b : budgets) {
    const size_t need = std::max(fac_potrf_smem<T>(nb, true),
                                 fac_trsm_smem<T>(nb, rows0, true));
    if (need <= b) return FacConfig{true, rows0, need};
  }
  FacConfig c{false, rows0, 0};
  while (c.rows > 1 && fac_trsm_smem<T>(nb, c.rows, false) > budgets[0])
    c.rows /= 2;
  c.smem = std::max(fac_potrf_smem<T>(nb, false),
                    fac_trsm_smem<T>(nb, c.rows, false));
  return c;
}

// One cooperative launch per part: parts[i] .. parts[i + 1] are runs of
// one kind of part, part_fac[i] says which (the parts alternate); runs
// past nruns (a stream cut short) are left out.
template <typename T, int TM>
int launch_tm(T* pool, Stream s, int nb, const int* parts,
              const int* part_fac, int nparts, int max_blocks,
              int* grid_out, void* stream) {
  const FacConfig c = fac_config<T>(nb);
  if (c.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t upd_smem = sizeof(UpdSmem<T, TM, TM>);
  int rows = c.rows;
  for (int i = 0; i < nparts && parts[i] < s.nruns; ++i) {
    int r0 = parts[i], r1 = parts[i + 1] < s.nruns ? parts[i + 1] : s.nruns;
    void* args[] = {&pool, &s, &nb, &rows, &r0, &r1};
    int grid = 0, e;
    if (!part_fac[i])
      e = launch_cooperative(mega_factor_kernel<T, TM, false, true>, NT,
                             upd_smem, max_blocks, &grid, args, stream);
    else if (c.in)
      e = launch_cooperative(mega_factor_kernel<T, TM, true, true>, NT,
                             c.smem, max_blocks, &grid, args, stream);
    else
      e = launch_cooperative(mega_factor_kernel<T, TM, true, false>, NT,
                             c.smem, max_blocks, &grid, args, stream);
    if (e != 0) return e;
    if (grid_out && grid > *grid_out) *grid_out = grid;
  }
  return 0;
}

template <typename T>
int launch(void* pool, const int* run_ptr, const int* run_kind,
           const int* run_seg, const int* run_rel, const int* run_split,
           const int* seg_ptr, const int* wr, const int* wc, const int* dst,
           const int* aux, const int* srcn, const int* relr, const int* relc,
           int* counters, int nruns, int nb, const int* parts,
           const int* part_fac, int nparts, int max_blocks, int* grid_out,
           void* stream) {
  if (grid_out) *grid_out = 0;
  if (nruns <= 0) return 0;
  Stream s{run_ptr, run_kind, run_seg, run_rel, run_split, seg_ptr,
           wr,      wc,       dst,     aux,     srcn,      relr,
           relc,    counters, nruns};
  if (nb <= 64)
    return launch_tm<T, 4>((T*)pool, s, nb, parts, part_fac, nparts,
                           max_blocks, grid_out, stream);
  return launch_tm<T, 8>((T*)pool, s, nb, parts, part_fac, nparts,
                         max_blocks, grid_out, stream);
}

}  // namespace

#define SPLLT_MEGA_FACTOR_ARGS                                              \
  void *pool, const int *run_ptr, const int *run_kind, const int *run_seg,  \
      const int *run_rel, const int *run_split, const int *seg_ptr,         \
      const int *wr, const int *wc, const int *dst, const int *aux,         \
      const int *srcn, const int *relr, const int *relc, int *counters,     \
      int nruns, int nb, const int *parts, const int *part_fac, int nparts, \
      int max_blocks, int *grid_out, void *stream

// counters: nruns ints, zero (device).  parts / part_fac: host arrays of
// nparts + 1 / nparts ints (see launch_tm).  max_blocks > 0 caps the grid
// (for tests of the item loops); grid_out receives the number of blocks
// launched.
extern "C" int spllt_mega_factor_f32(SPLLT_MEGA_FACTOR_ARGS) {
  return launch<float>(pool, run_ptr, run_kind, run_seg, run_rel, run_split,
                       seg_ptr, wr, wc, dst, aux, srcn, relr, relc, counters,
                       nruns, nb, parts, part_fac, nparts, max_blocks,
                       grid_out, stream);
}
extern "C" int spllt_mega_factor_f64(SPLLT_MEGA_FACTOR_ARGS) {
  return launch<double>(pool, run_ptr, run_kind, run_seg, run_rel,
                        run_split, seg_ptr, wr, wc, dst, aux, srcn, relr,
                        relc, counters, nruns, nb, parts, part_fac, nparts,
                        max_blocks, grid_out, stream);
}
