// One destination segment of the fused gather-GEMM-accumulate update, by
// one thread block of kUpdNT threads.
//
// Micro-task t of the segment [t0, t1):
//   R[i, :] = pool[lor[t] + relr[t, i], :srcn[t]]  (zero when relr < 0)
//   C[j, :] = pool[loc[t] + relc[t, j], :srcn[t]]  (zero when relc < 0 or
//                                                   j >= blkn[t])
// and the BM x BN piece at (i0, j0) of the destination tile whose first row
// in the flat pool is dst_row gets  -= sum_t R * C^T.  The block loops over
// the segment's micro-tasks, keeps the sum in registers and subtracts it
// from the destination once: no atomics, and the result does not depend on
// the order blocks run in.  The gathers are exact indexed row loads.  The
// product is a register-tiled FMA GEMM: a TM x TN patch per thread (8 x 8,
// or 4 x 4 in the small configuration used for nb <= 64), operands staged
// k-major through two shared-memory buffers in slabs of 8 contraction
// steps, read back with 16-byte loads; the next slab's global loads are
// started into registers before the current slab is multiplied, so they
// overlap the arithmetic and one barrier per slab is enough.  Most
// micro-tasks are sparse, so the slab loop stops at srcn[t]; a micro-task
// none of whose rows (or columns) falls into the block's piece is skipped;
// a 64-wide half of the piece whose rows (or columns) are all masked in a
// task skips its share of the arithmetic, and so does a warp whose own
// destination rows are all masked.
//
// The row tables relr / relc are indexed by t - rel_shift (the stream
// kernel keeps them for its update tasks only).  The pool is read and
// written through an ordinary pointer.
#pragma once
#include "common.cuh"

namespace spllt {

constexpr int kUpdBK = 8;      // contraction slab
constexpr int kUpdNT = 256;    // threads per block, as a 16 x 16 grid

// TM x TN values per thread (multiples of 4), BM = 16*TM, BN = 16*TN.
template <typename T, int TM, int TN>
struct alignas(16) UpdSmem {
  static constexpr int BM = 16 * TM, BN = 16 * TN;
  static constexpr int LDA = BM + 4, LDB = BN + 4;   // keep 16-byte alignment
  T as[2][kUpdBK][LDA];
  T bs[2][kUpdBK][LDB];
  long long rowr[BM];   // source row of R row i, -1 = masked
  long long rowc[BN];
  int flags[2];         // per task: bit g = row group g has an unmasked
                        // row, bit NVM + h = column group
};

// Thread (tx, ty) owns rows  g*(BM/NVM) + ty*4 + q  and columns
// g*(BN/NVN) + tx*4 + q  (g-th group of 4, q = 0..3): a warp reads one or
// two 16-byte words of the R slab (broadcast) and 16 neighbouring 16-byte
// words of the C slab, and writes neighbouring 16-byte pieces of dst rows.
// Starts with a block barrier of its own (after resetting the flags), so a
// caller only has to keep other users of the shared memory behind a
// barrier at its end.
template <typename T, int TM, int TN>
__device__ __forceinline__ void update_segment(
    T* pool, const int* lor, const int* loc, const int* blkn,
    const int* srcn, const int* relr, const int* relc, int rel_shift,
    long long dst_row, int nb, int t0, int t1, int i0, int j0,
    UpdSmem<T, TM, TN>& sm, int tid) {
  constexpr int BK = kUpdBK, NT = kUpdNT;
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int NVM = TM / 4, NVN = TN / 4;
  constexpr int EA = BM * BK / NT, EB = BN * BK / NT;  // staged per thread
  const int tx = tid & 15, ty = tid >> 4;

  if (tid < 2) sm.flags[tid] = 0;
  __syncthreads();

  T acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = T(0);

  T ra[EA], rb[EB];   // next slab, on its way from global memory

  for (int t = t0; t < t1; ++t) {
    int* fl = &sm.flags[(t - t0) & 1];
    const size_t trow = (size_t)(t - rel_shift) * nb;
    int bits = 0;
    for (int e = tid; e < BM + BN; e += NT) {
      if (e < BM) {
        const int i = i0 + e;
        const int rel = i < nb ? relr[trow + i] : -1;
        sm.rowr[e] = rel >= 0 ? (long long)lor[t] + rel : -1;
        if (rel >= 0) bits |= 1 << (e / (BM / NVM));
      } else {
        const int j = j0 + e - BM;
        const int rel = (j < nb && j < blkn[t]) ? relc[trow + j] : -1;
        sm.rowc[e - BM] = rel >= 0 ? (long long)loc[t] + rel : -1;
        if (rel >= 0) bits |= 1 << (NVM + (e - BM) / (BN / NVN));
      }
    }
    if (bits) atomicOr(fl, bits);
    // fences the row tables, the flags and the previous task's last reads
    // of the slabs
    __syncthreads();
    const int live = *fl;
    if (tid == 0) sm.flags[(t - t0 + 1) & 1] = 0;     // for the next task
    const int kn = min(srcn[t], nb);
    const int nslab = (kn + BK - 1) / BK;
    if (!(live & ((1 << NVM) - 1)) || !(live >> NVM) || nslab == 0) {
      __syncthreads();          // the reset above must precede the next vote
      continue;
    }

    // which of this thread's 4 x 4 blocks have work: row group g needs an
    // unmasked row among this warp's rows, column group h among all columns
    bool rg[NVM], cg[NVN];
#pragma unroll
    for (int g = 0; g < NVM; ++g) {
      int mine = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mine |= sm.rowr[g * (BM / NVM) + ty * 4 + q] >= 0;
      rg[g] = __any_sync(kFull, mine);
    }
#pragma unroll
    for (int h = 0; h < NVN; ++h) cg[h] = (live >> (NVM + h)) & 1;

    auto fetch = [&](int s) {   // slab s: global -> registers
      const int k0 = s * BK;
#pragma unroll
      for (int e = 0; e < EA; ++e) {
        const int idx = tid + e * NT, row = idx / BK, k = k0 + idx % BK;
        const long long sr = sm.rowr[row];
        ra[e] = (sr >= 0 && k < kn) ? pool[(size_t)sr * nb + k] : T(0);
      }
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int idx = tid + e * NT, row = idx / BK, k = k0 + idx % BK;
        const long long sc = sm.rowc[row];
        rb[e] = (sc >= 0 && k < kn) ? pool[(size_t)sc * nb + k] : T(0);
      }
    };
    auto stash = [&](int buf) {  // registers -> shared, k-major
#pragma unroll
      for (int e = 0; e < EA; ++e) {
        const int idx = tid + e * NT;
        sm.as[buf][idx % BK][idx / BK] = ra[e];
      }
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int idx = tid + e * NT;
        sm.bs[buf][idx % BK][idx / BK] = rb[e];
      }
    };

    fetch(0);
    stash(0);
    __syncthreads();
    for (int s = 0; s < nslab; ++s) {
      const int buf = s & 1;
      if (s + 1 < nslab) fetch(s + 1);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        Vec4<T> a[NVM], b[NVN];
#pragma unroll
        for (int g = 0; g < NVM; ++g)
          if (rg[g])
            a[g] = *reinterpret_cast<const Vec4<T>*>(
                &sm.as[buf][kk][g * (BM / NVM) + ty * 4]);
#pragma unroll
        for (int h = 0; h < NVN; ++h)
          if (cg[h])
            b[h] = *reinterpret_cast<const Vec4<T>*>(
                &sm.bs[buf][kk][h * (BN / NVN) + tx * 4]);
#pragma unroll
        for (int g = 0; g < NVM; ++g)
#pragma unroll
          for (int h = 0; h < NVN; ++h)
            if (rg[g] && cg[h]) {
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                  acc[g * 4 + u][h * 4 + v] += a[g].v[u] * b[h].v[v];
            }
      }
      if (s + 1 < nslab) stash(buf ^ 1);
      __syncthreads();
    }
  }

  if (t1 > t0) {
    T* d = pool + (size_t)dst_row * nb;
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int i = i0 + (u / 4) * (BM / NVM) + ty * 4 + (u % 4);
      if (i >= nb) continue;
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        const int j = j0 + (v / 4) * (BN / NVN) + tx * 4 + (v % 4);
        if (j < nb) d[(size_t)i * nb + j] -= acc[u][v];
      }
    }
  }
}

}  // namespace spllt
