// The whole numeric factorization as one stream of launches (Hopper,
// sm_90a).
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
// also have their live rows and columns as packed entries (eptr / enr /
// ent, numeric/hopper_update.py pack_live_entries, packed run by run), and
// every UPD run the offsets seg_ptr of its runs of equal dst and a dense
// flag.
//
// Bound: the sum of its bodies' bounds (bytes for the sparse update tasks
// and the leaf potrf tiles, the dependent chains of potrf and trsm on the
// narrow top levels) plus one launch or grid barrier per run.  The TPU
// kernel walks the stream in a sequential grid, one group of tasks per
// step, with double-buffered window copies, a carried accumulator and drain
// flags at the run boundaries; blocks here run in no order, so the runs go
// in parts of one kind (UPD runs, or POTRF and TRSM runs), and the launch
// boundary orders one part before the next:
//   UPD    each run is one ordinary launch of the batched update kernel's
//          compact body (update_compact.cuh, K3's): one block per
//          destination segment, its tasks summed in registers over their
//          live rows and columns and the destination's live cells read and
//          written once - deterministic, no atomics; two blocks an SM, one
//          for a run of long chains of near-dense tasks (its dense flag);
//          float pools also in one TF32 pass on the tensor cores
//          (spllt_mega_factor_f32_tf32: the TPU kernel's DEFAULT product;
//          POTRF and TRSM stay IEEE);
//   POTRF  one cooperative launch of as many blocks as fit the card loops
//   TRSM   over the part's runs with a grid barrier between two runs, the
//          blocks taking a run's work items from a counter (whichever
//          block is free takes the next one; a block's first item is its
//          block index): a POTRF item is one tile in place, a TRSM item 64 /
//          run_split[r] rows of one (diag, dst) pair in place (the bodies of
//          mega_factor_body.cuh, this kernel's own).  Most such runs near
//          the root have fewer items than the card has blocks, so a run
//          lasts one grid barrier plus the latency of its slowest item; the
//          bodies are built to cut that latency, and a TRSM run with few
//          pairs cuts them into bands of fewer rows so that more blocks
//          share the run.
// The two kernels hold one body each: the float update body sits at the
// register cap of two blocks an SM, and other bodies in the same kernel
// made the UPD runs 9-50 % slower.  There is no gathered copy of tiles in
// or out.  The POTRF/TRSM kernel reads and writes the pool through an
// ordinary pointer: a run reads what an earlier run of the same launch
// wrote, which the grid barrier orders for ordinary loads and for
// cp.async.cg (through L2), but not for the read-only path nor for
// cp.async.ca.  It runs 256 threads a block; the host keeps its shared
// memory under half an SM's where the tiles allow, so that two blocks
// share an SM.
#include <cooperative_groups.h>

#include <algorithm>

#include "mega_factor_body.cuh"
#include "update_compact.cuh"

namespace {

using namespace spllt;
namespace coop = cooperative_groups;

constexpr int KIND_POTRF = 1, KIND_TRSM = 2;

struct FacStream {
  const int* run_ptr;    // [nruns + 1] first task of each run
  const int* run_kind;   // [nruns]
  const int* run_split;  // [nruns] TRSM runs: items of kTrsmItemRows / split
                         // dst rows (1, 2 or 4)
  const int* wr;
  const int* dst;
  const int* aux;
  int* counters;         // [nruns] zero at launch: next work item of a run
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

// Runs [r0, r1) of one POTRF/TRSM part, a grid barrier between consecutive
// runs.  IN: the POTRF tile and the TRSM factor fit in shared memory.
// Float kernels are held to the registers that let two blocks share an SM.
template <typename T, bool IN>
__global__ void __launch_bounds__(kFacNT, sizeof(T) == 4 ? 2 : 1)
mega_factor_kernel(T* pool, FacStream s, int nb, int trsm_rows, int r0,
                   int r1) {
  __shared__ int slot;
  coop::grid_group grid = coop::this_grid();
  const int tid = threadIdx.x;

  for (int r = r0; r < r1; ++r) {
    const int kind = s.run_kind[r];
    const int t0 = s.run_ptr[r], n = s.run_ptr[r + 1] - t0;
    if (kind == KIND_POTRF) {
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

struct UpdTables {
  const int* seg_ptr;    // per UPD run nseg + 1 task offsets
  const int* wr;
  const int* wc;
  const int* dst;        // row bases
  const int* srcn;
  const int* eptr;       // [tasks + 1] packed live entries of each task
  const int* enr;        // [tasks] live rows (+ CHAIN)
  const int* ent;
};

// parts[i] .. parts[i + 1] are runs of one kind of part, part_fac[i] says
// which (the parts alternate); runs past nruns (a stream cut short) are
// left out.  A UPD part launches each of its runs on its own: run r's
// segments are seg_ptr[run_seg[r] .. run_seg[r + 1]] (run_seg and
// run_dense are host arrays).  A POTRF/TRSM part is one cooperative launch.
// P: the update body's product (update_compact.cuh).
template <typename T, int P>
int launch(T* pool, FacStream s, const UpdTables& u, int nruns, int nb,
           const int* parts, const int* part_fac, int nparts,
           const int* run_seg, const int* run_dense, int max_blocks,
           int* grid_out, void* stream) {
  if (grid_out) *grid_out = 0;
  const FacConfig c = fac_config<T>(nb);
  if (c.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int rows = c.rows;
  for (int i = 0; i < nparts && parts[i] < nruns; ++i) {
    int r0 = parts[i], r1 = std::min(parts[i + 1], nruns);
    int e = 0;
    if (!part_fac[i]) {
      for (int r = r0; r < r1 && e == 0; ++r)
        e = update_launch<T, P>(pool, u.seg_ptr + run_seg[r], u.dst, u.wr,
                                u.wc, u.srcn, u.eptr, u.enr, u.ent,
                                run_seg[r + 1] - run_seg[r] - 1, nb, 1,
                                run_dense[r], stream);
    } else {
      void* args[] = {&pool, &s, &nb, &rows, &r0, &r1};
      int grid = 0;
      e = c.in ? launch_cooperative(mega_factor_kernel<T, true>, kFacNT,
                                    c.smem, max_blocks, &grid, args, stream)
               : launch_cooperative(mega_factor_kernel<T, false>, kFacNT,
                                    c.smem, max_blocks, &grid, args, stream);
      if (grid_out && grid > *grid_out) *grid_out = grid;
    }
    if (e != 0) return e;
  }
  return 0;
}

}  // namespace

#define SPLLT_MEGA_FACTOR_ARGS                                               \
  void *pool, const int *run_ptr, const int *run_kind, const int *run_split, \
      const int *seg_ptr, const int *wr, const int *wc, const int *dst,      \
      const int *aux, const int *srcn, const int *eptr, const int *enr,      \
      const int *ent, int *counters, int nruns, int nb, const int *parts,    \
      const int *part_fac, int nparts, const int *run_seg,                   \
      const int *run_dense, int max_blocks, int *grid_out, void *stream
#define SPLLT_MEGA_FACTOR_CALL(T, P)                                         \
  launch<T, P>((T*)pool,                                                     \
               FacStream{run_ptr, run_kind, run_split, wr, dst, aux,         \
                         counters},                                          \
               UpdTables{seg_ptr, wr, wc, dst, srcn, eptr, enr, ent}, nruns, \
               nb, parts, part_fac, nparts, run_seg, run_dense, max_blocks,  \
               grid_out, stream)

// Device tables: run_ptr .. ent; counters: nruns ints, zero.  Host arrays:
// parts / part_fac (nparts + 1 / nparts ints, see launch), run_seg
// (nruns + 1) and run_dense (nruns).  max_blocks > 0 caps the grid of the
// cooperative POTRF/TRSM launches (for tests of their item loops); grid_out
// receives the most blocks one of them ran.  A UPD launch runs one block
// per segment whatever max_blocks says.  The _tf32 entry point runs the UPD
// runs' products on the tensor cores.
extern "C" int spllt_mega_factor_f32(SPLLT_MEGA_FACTOR_ARGS) {
  return SPLLT_MEGA_FACTOR_CALL(float, spllt::kIeee);
}
extern "C" int spllt_mega_factor_f64(SPLLT_MEGA_FACTOR_ARGS) {
  return SPLLT_MEGA_FACTOR_CALL(double, spllt::kIeee);
}
extern "C" int spllt_mega_factor_f32_tf32(SPLLT_MEGA_FACTOR_ARGS) {
  return SPLLT_MEGA_FACTOR_CALL(float, spllt::kTf32);
}
