// The whole numeric factorization as one persistent kernel (Hopper, sm_90a).
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
// narrow top levels) plus one grid barrier per run.  The TPU kernel walks
// the stream in a sequential grid, one group of tasks per step, with
// double-buffered window copies, a carried accumulator and drain flags at
// the run boundaries; blocks here run in no order, so instead ONE
// cooperative launch of as many blocks as fit the card loops over the runs,
// the blocks take a run's work items from a counter (whichever block is
// free takes the next one), and a grid barrier at each run boundary takes
// the place of the drain.  Work items:
//   UPD    one destination segment (piece): its tasks are summed in
//          registers and the destination is read and written once
//          (update_body.cuh) - deterministic, no atomics;
//   POTRF  one tile, in place on the pool (potrf_body.cuh);
//   TRSM   rb rows of one (diag, dst) pair, in place (trsm_body.cuh).
// There is no gathered copy of tiles in or out.  The pool is read and
// written through an ordinary pointer everywhere: a run reads what an
// earlier run of the same launch wrote, which the grid barrier orders for
// ordinary loads but not for the read-only path.  All bodies share one
// block size (256 threads) and one dynamic shared-memory size, the largest
// any of them needs; the host keeps it under half an SM's shared memory
// where the tiles allow, so that two blocks share an SM.
#include <cooperative_groups.h>

#include "potrf_body.cuh"
#include "trsm_body.cuh"
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

// float kernels are held to the registers that let two blocks share an SM
template <typename T, int TM, bool LSMEM>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
mega_factor_kernel(T* pool, Stream s, int nb, int potrf_in_smem, int rb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int slot;
  coop::grid_group grid = coop::this_grid();
  constexpr int BM = 16 * TM;
  const int tid = threadIdx.x;
  const int npc = (nb + BM - 1) / BM;      // pieces of a tile, per side
  const int nrb = (nb + rb - 1) / rb;      // row blocks of a trsm pair

  for (int r = 0; r < s.nruns; ++r) {
    const int kind = s.run_kind[r];
    const int t0 = s.run_ptr[r], n = s.run_ptr[r + 1] - t0;
    if (kind == KIND_UPD) {
      const int sg0 = s.run_seg[r];
      const int nseg = s.run_seg[r + 1] - sg0 - 1;
      const int shift = s.run_rel[r];
      auto& sm = *reinterpret_cast<UpdSmem<T, TM, TM>*>(smem_raw);
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
      for (int item; (item = next_item(s.counters + r, &slot, tid)) < n;) {
        const int t = t0 + item;
        T* tile = pool + (size_t)s.dst[t] * nb;
        potrf_tile<T>(tile, tile, s.aux[t], nb, potrf_in_smem, smem_raw, tid,
                      NT);
      }
    } else if (kind == KIND_TRSM) {
      for (int item; (item = next_item(s.counters + r, &slot, tid)) <
                     n * nrb;) {
        const int t = t0 + item / nrb;
        T* d = pool + (size_t)s.dst[t] * nb;
        trsm_rows<T, LSMEM>(pool + (size_t)s.wr[t] * nb, d, d, s.aux[t], nb,
                            (item % nrb) * rb, rb, smem_raw, tid, NT);
      }
    }
    grid.sync();
  }
}

template <typename T, int TM, bool LSMEM>
int launch_cfg(T* pool, Stream s, int nb, int potrf_in, int rb, size_t smem,
               int max_blocks, int* grid_out, void* stream) {
  void* args[] = {&pool, &s, &nb, &potrf_in, &rb};
  return launch_cooperative(mega_factor_kernel<T, TM, LSMEM>, NT, smem,
                            max_blocks, grid_out, args, stream);
}

template <typename T, int TM>
int launch_tm(T* pool, Stream s, int nb, int max_blocks, int* grid_out,
              void* stream) {
  // one shared-memory size for all bodies: first try to keep every tile in
  // shared memory within half an SM (two blocks an SM), then within a whole
  // block's allowance, where what does not fit works on global memory
  int potrf_in = 0, rb = 0, l_in = 0;
  size_t smem = 0;
  const size_t budgets[2] = {(size_t)kHalfSmem, (size_t)kMaxSmem};
  for (size_t budget : budgets) {
    potrf_in = potrf_smem<T>(nb, true) <= budget;
    trsm_config<T>(nb, budget, &rb, &l_in);
    smem = sizeof(UpdSmem<T, TM, TM>);
    if (potrf_smem<T>(nb, potrf_in) > smem) smem = potrf_smem<T>(nb, potrf_in);
    if (trsm_smem<T>(nb, rb, l_in) > smem) smem = trsm_smem<T>(nb, rb, l_in);
    if (potrf_in && l_in) break;
  }
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (l_in)
    return launch_cfg<T, TM, true>(pool, s, nb, potrf_in, rb, smem,
                                   max_blocks, grid_out, stream);
  return launch_cfg<T, TM, false>(pool, s, nb, potrf_in, rb, smem, max_blocks,
                                  grid_out, stream);
}

template <typename T>
int launch(void* pool, const int* run_ptr, const int* run_kind,
           const int* run_seg, const int* run_rel, const int* seg_ptr,
           const int* wr, const int* wc, const int* dst, const int* aux,
           const int* srcn, const int* relr, const int* relc, int* counters,
           int nruns, int nb, int max_blocks, int* grid_out, void* stream) {
  if (grid_out) *grid_out = 0;
  if (nruns <= 0) return 0;
  Stream s{run_ptr, run_kind, run_seg, run_rel, seg_ptr,  wr,   wc,
           dst,     aux,      srcn,    relr,    relc,     counters, nruns};
  if (nb <= 64)
    return launch_tm<T, 4>((T*)pool, s, nb, max_blocks, grid_out, stream);
  return launch_tm<T, 8>((T*)pool, s, nb, max_blocks, grid_out, stream);
}

}  // namespace

#define SPLLT_MEGA_FACTOR_ARGS                                              \
  void *pool, const int *run_ptr, const int *run_kind, const int *run_seg,  \
      const int *run_rel, const int *seg_ptr, const int *wr, const int *wc, \
      const int *dst, const int *aux, const int *srcn, const int *relr,     \
      const int *relc, int *counters, int nruns, int nb, int max_blocks,    \
      int *grid_out, void *stream

// counters: nruns ints, zero.  max_blocks > 0 caps the grid (for tests of
// the item loops); grid_out receives the number of blocks launched.
extern "C" int spllt_mega_factor_f32(SPLLT_MEGA_FACTOR_ARGS) {
  return launch<float>(pool, run_ptr, run_kind, run_seg, run_rel, seg_ptr, wr,
                       wc, dst, aux, srcn, relr, relc, counters, nruns, nb,
                       max_blocks, grid_out, stream);
}
extern "C" int spllt_mega_factor_f64(SPLLT_MEGA_FACTOR_ARGS) {
  return launch<double>(pool, run_ptr, run_kind, run_seg, run_rel, seg_ptr,
                        wr, wc, dst, aux, srcn, relr, relc, counters, nruns,
                        nb, max_blocks, grid_out, stream);
}
