// Right triangular solve  dst <- dst * L^-T  of rb rows of one (diag, dst)
// pair by one thread block.
//
// L is the leading kv x kv lower triangle of the diag tile that potrf
// wrote; output columns >= kv are zero.  The rows of dst are independent
// (row r solves x L^T = d_r), so each dst row goes to ONE thread and there
// is no barrier inside the substitution: all nt threads copy the block's
// rb rows of dst (column major, so that the threads of a warp touch
// neighbouring words) and the lower part of the L tile (row major) into
// shared memory, then thread t < rb walks the columns of row r0 + t in
// panels of 8 held in registers: the finished columns are eliminated from
// the panel with 16-byte broadcast loads of L (4 contraction steps per
// load), then the 8 x 8 triangle is solved in registers.  With LSMEM false
// the L tile is read where it lies in global memory (every thread of a warp
// reads the same words).  dst and out may be the same tile: a block reads
// its rows whole before it writes them.
#pragma once
#include "common.cuh"

namespace spllt {

constexpr int kTrsmRbMax = 128;  // most dst rows per block
constexpr int kTrsmP = 8;        // columns per register panel

// shared memory of trsm_rows for rb rows, with or without the L tile
template <typename T>
inline size_t trsm_smem(int nb, int rb, bool l_in) {
  const int ld = (nb + 3) / 4 * 4;
  return ((l_in ? (size_t)nb * ld : 0) + (size_t)nb * (rb + 1)) * sizeof(T);
}

// Rows per block and where L lies, for a shared-memory budget: as many dst
// rows as fit beside the L tile, up to all of them; if not even 32 rows fit
// there, L stays in global memory and only the dst rows are staged.
template <typename T>
inline void trsm_config(int nb, size_t budget, int* rb_out, int* l_in_out) {
  int rb = kTrsmRbMax;
  while (rb > 32 && rb / 2 >= nb) rb /= 2;          // small tiles
  const int rb0 = rb;
  int l_in = 1;
  while (rb > 32 && trsm_smem<T>(nb, rb, true) > budget) rb /= 2;
  if (trsm_smem<T>(nb, rb, true) > budget) {
    l_in = 0;
    rb = rb0;
    while (rb > 1 && trsm_smem<T>(nb, rb, false) > budget) rb /= 2;
  }
  *rb_out = rb;
  *l_in_out = l_in;
}

// Four neighbouring entries of a row of L: one 16-byte load where the
// address allows it (always in shared memory).
template <typename T>
__device__ __forceinline__ Vec4<T> load4(const T* p, bool vec) {
  if (vec) return *reinterpret_cast<const Vec4<T>*>(p);
  Vec4<T> r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.v[i] = p[i];
  return r;
}

// acc[jj] -= sum_c x[c] * L[j0+jj][c] for c < j0, then the P x P triangle.
// Only the lower part of L (c <= row) is read.
// FULL: the whole panel lies below kv (no per-column guards).  LSMEM: ls is
// the copy of L in shared memory.
template <typename T, bool FULL, bool LSMEM>
__device__ __forceinline__ void trsm_panel(const T* ls, T* xs, int ld,
                                           int rbp, int tid, int j0, int kv,
                                           int nb, bool vec) {
  constexpr int P = kTrsmP;
  T acc[P];
#pragma unroll
  for (int jj = 0; jj < P; ++jj)
    acc[jj] = (FULL || j0 + jj < nb) ? xs[(j0 + jj) * rbp + tid] : T(0);
  for (int c = 0; c < j0; c += 4) {
    const T x0 = xs[c * rbp + tid], x1 = xs[(c + 1) * rbp + tid];
    const T x2 = xs[(c + 2) * rbp + tid], x3 = xs[(c + 3) * rbp + tid];
#pragma unroll
    for (int jj = 0; jj < P; ++jj) {
      if (FULL || j0 + jj < kv) {
        const Vec4<T> l = load4(ls + (size_t)(j0 + jj) * ld + c, LSMEM || vec);
        acc[jj] -= x0 * l.v[0];
        acc[jj] -= x1 * l.v[1];
        acc[jj] -= x2 * l.v[2];
        acc[jj] -= x3 * l.v[3];
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < P; ++jj) {
    const int j = j0 + jj;
    if (FULL || j < kv) {
      const T xj = acc[jj] / ls[j * ld + j];
      acc[jj] = xj;
#pragma unroll
      for (int j2 = jj + 1; j2 < P; ++j2)
        if (FULL || j0 + j2 < kv) acc[j2] -= xj * ls[(j0 + j2) * ld + j];
    } else {
      acc[jj] = T(0);
    }
  }
#pragma unroll
  for (int jj = 0; jj < P; ++jj)
    if (FULL || j0 + jj < nb) xs[(j0 + jj) * rbp + tid] = acc[jj];
}

// l, dst, out: the pair's tiles [nb, nb]; rows r0 .. r0 + rb - 1 of dst are
// solved (rb <= nt).  Ends with every thread's writes to out made; the
// caller puts a block barrier before the shared memory is used again.
template <typename T, bool LSMEM>
__device__ __forceinline__ void trsm_rows(const T* l, const T* dst, T* out,
                                          int kv, int nb, int r0, int rb,
                                          unsigned char* smem_raw, int tid,
                                          int nt) {
  constexpr int P = kTrsmP;
  T* lsm = reinterpret_cast<T*>(smem_raw);  // [nb][ld] L, when it fits
  const int ld = LSMEM ? (nb + 3) / 4 * 4 : nb;
  // [nb][rb + 1] dst rows, by column
  T* xs = lsm + (LSMEM ? (size_t)nb * ld : 0);
  const int rbp = rb + 1;

  const bool vec =
      nb % 4 == 0 && reinterpret_cast<size_t>(l) % sizeof(Vec4<T>) == 0;
  if (LSMEM)
    for (int idx = tid; idx < kv * nb; idx += nt) {
      const int j = idx / nb, c = idx - j * nb;
      if (c <= j) lsm[j * ld + c] = l[idx];
    }
  for (int idx = tid; idx < rb * nb; idx += nt) {
    const int rl = idx / nb, c = idx - rl * nb;
    const int r = r0 + rl;
    xs[c * rbp + rl] = (r < nb && c < kv) ? dst[(size_t)r * nb + c] : T(0);
  }
  __syncthreads();

  if (tid < rb && r0 + tid < nb) {
    const T* ls = LSMEM ? lsm : l;
    int j0 = 0;
    for (; j0 + P <= kv; j0 += P)
      trsm_panel<T, true, LSMEM>(ls, xs, ld, rbp, tid, j0, kv, nb, vec);
    if (j0 < kv)
      trsm_panel<T, false, LSMEM>(ls, xs, ld, rbp, tid, j0, kv, nb, vec);
  }
  __syncthreads();

  for (int idx = tid; idx < rb * nb; idx += nt) {
    const int rl = idx / nb, c = idx - rl * nb;
    const int r = r0 + rl;
    if (r < nb) out[(size_t)r * nb + c] = xs[c * rbp + rl];
  }
}

}  // namespace spllt
