// Fused gather-GEMM-accumulate update of the factor pool (Hopper, sm_90a).
//
// Replaces the TPU kernel spllt_tpu/numeric/pallas_update.py
// (pallas_apply_updates / _kernel / onehot_gather).  The flat pool is
// [rows, nb].  Micro-task t, sorted by destination tile dst[t]:
//   R[i, :] = pool[lor[t] + relr[t, i], :srcn[t]]  (zero when relr < 0)
//   C[j, :] = pool[loc[t] + relc[t, j], :srcn[t]]  (zero when relc < 0 or
//                                                   j >= blkn[t])
//   pool[dst*nb : dst*nb+nb, :] -= R * C^T
// srcn[t] is the number of valid columns of the source block column: the
// pool keeps the columns beyond it at zero, so contracting over the first
// srcn[t] columns only is the same product with less work.
// Tasks with equal dst form one segment; their products are summed and the
// destination tile is read and written once.
//
// Bound: a full micro-task is bound by operations (2*nb^3 against three
// tile reads), but most micro-tasks are sparse, so by the count of what the
// unmasked work needs a factorization's updates are bound by bytes, and in
// practice by the latency of each micro-task's dependent loads.
// The TPU kernel walks the tasks in a sequential grid and carries the
// accumulator from step to step; blocks here run in no order, so the
// sequential dimension becomes a loop inside the block: one thread block
// owns one BM x BN piece of one destination segment (the whole tile at
// nb = 128), loops over the segment's micro-tasks, keeps the sum in
// registers and subtracts it from the destination once.  No atomics, and
// the result does not depend on the order blocks run in.  The gathers are
// exact indexed row loads.  The product is a classic register-tiled FMA
// GEMM: 256 threads, an 8 x 8 patch per thread (4 x 4 in the small
// configuration used for nb <= 64), operands staged k-major through two
// shared-memory buffers in slabs of 8 contraction steps, read back with
// 16-byte loads; the next slab's global loads are started into registers
// before the current slab is multiplied, so they overlap the arithmetic
// and one barrier per slab is enough.  Most micro-tasks are sparse (few
// unmasked rows and columns, narrow sources), so the kernel does not do the
// dense work blindly: the slab loop stops at srcn[t]; a micro-task none of
// whose rows (or columns) falls into the block's piece is skipped; a
// 64-wide half of the piece whose rows (or columns) are all masked in a task
// skips its share of the arithmetic, and so does a warp whose own
// destination rows are all masked.  Within a level no destination tile is also a source,
// so updating in place is safe.  The segment loop itself is update_segment in
// update_body.cuh, which the factor stream kernel (mega_factor.cu) runs too.
#include "update_body.cuh"

namespace {

using namespace spllt;

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kUpdNT)
update_kernel(T* __restrict__ pool, const int* __restrict__ seg_ptr,
              const int* __restrict__ dst, const int* __restrict__ lor,
              const int* __restrict__ loc, const int* __restrict__ blkn,
              const int* __restrict__ srcn, const int* __restrict__ relr,
              const int* __restrict__ relc, int nb) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  __shared__ UpdSmem<T, TM, TN> sm;
  const int seg = blockIdx.x;
  const int ntn = (nb + BN - 1) / BN;
  const int t0 = seg_ptr[seg], t1 = seg_ptr[seg + 1];
  if (t1 <= t0) return;
  update_segment<T, TM, TN>(pool, lor, loc, blkn, srcn, relr, relc, 0,
                            (long long)dst[t0] * nb, nb, t0, t1,
                            (blockIdx.y / ntn) * BM, (blockIdx.y % ntn) * BN,
                            sm, threadIdx.x);
}

template <typename T, int TM, int TN>
int launch_cfg(void* pool, const int* seg_ptr, const int* dst, const int* lor,
               const int* loc, const int* blkn, const int* srcn,
               const int* relr, const int* relc, int nseg, int nb,
               void* stream) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  const int ntm = (nb + BM - 1) / BM, ntn = (nb + BN - 1) / BN;
  dim3 grid(nseg, ntm * ntn);
  update_kernel<T, TM, TN><<<grid, kUpdNT, 0, (cudaStream_t)stream>>>(
      (T*)pool, seg_ptr, dst, lor, loc, blkn, srcn, relr, relc, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* pool, const int* seg_ptr, const int* dst, const int* lor,
           const int* loc, const int* blkn, const int* srcn, const int* relr,
           const int* relc, int nseg, int nb, void* stream) {
  if (nseg <= 0) return 0;
  if (nb <= 64)
    return launch_cfg<T, 4, 4>(pool, seg_ptr, dst, lor, loc, blkn, srcn, relr,
                               relc, nseg, nb, stream);
  return launch_cfg<T, 8, 8>(pool, seg_ptr, dst, lor, loc, blkn, srcn, relr,
                             relc, nseg, nb, stream);
}

}  // namespace

extern "C" int spllt_update_f32(void* pool, const int* seg_ptr,
                                const int* dst, const int* lor,
                                const int* loc, const int* blkn,
                                const int* srcn, const int* relr,
                                const int* relc, int nseg, int nb,
                                void* stream) {
  return launch<float>(pool, seg_ptr, dst, lor, loc, blkn, srcn, relr, relc,
                      nseg, nb, stream);
}
extern "C" int spllt_update_f64(void* pool, const int* seg_ptr,
                                const int* dst, const int* lor,
                                const int* loc, const int* blkn,
                                const int* srcn, const int* relr,
                                const int* relc, int nseg, int nb,
                                void* stream) {
  return launch<double>(pool, seg_ptr, dst, lor, loc, blkn, srcn, relr, relc,
                      nseg, nb, stream);
}
