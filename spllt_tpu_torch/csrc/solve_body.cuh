// Left triangular solve of one rhs chunk against one tile, by one block of
// kSolNT threads (the batched left-solve kernel, solve.cu).
//
// With kv factor columns, m = tile + I on the diagonal of rows >= kv (the
// tile is the masked lower output of potrf: columns >= kv are zero).
// Solves  m y = z  (forward) or  m^T y = z  (transpose) for the nb x rc
// chunk z whose rows lie ldz elements apart.
//   forward:   per panel of <= 32 columns, the panel's diagonal block is
//              solved, then the panel is subtracted from every row below
//              it (rows >= kv included: their identity diagonal makes
//              y_i = z_i - m[i, :kv] y).
//   transpose: rows >= kv pass through; they are first folded into the
//              rows < kv, then the panels are solved from the last one up,
//              each subtracted from the rows above it.
//
// A launch is one short chain of dependent steps per tile, so its time is
// latency: the copies in, the block barriers and the substitution.  So
//   - the tile's first kv columns (the trapezoid that is read) and the rhs
//     chunk are copied into shared memory at once, by 16-byte cp.async.cg
//     where the rows line up (ordinary loads elsewhere), and waited for
//     once (fac_stage, shared with the factor stream kernel's bodies);
//   - a warp solves the panel's diagonal block in registers for its rhs
//     columns (lane = row in the forward direction, column in the
//     transposed one; one shuffle a column and step), with the reciprocal
//     of each pivot computed before the chain, which holds no division;
//     lanes past the panel hold an identity row, so every panel runs its
//     steps without a guard;
//   - the block applies the panel as a register-tiled product: a thread
//     holds TR rows x 4 rhs columns of the rows below (above) the panel
//     (TR = 4, 2 or 1 by how many outputs there are) and, where there are
//     few, neighbouring lanes split the contraction and sum it with
//     shuffles in a fixed order;
// two block barriers a panel.  Tiles that do not fit in shared memory
// (nb = 256 in float32) are read from global memory.  y is written to y0;
// z may be y0: the chunk is read whole before anything is written.
#pragma once
// the staging and arithmetic helpers of the factor stream kernel's bodies
// (fac_stage, fac_cp_wait_all, fac_rcp, fac_load4, FacVec, fac_round4)
#include "mega_factor_body.cuh"

namespace spllt {

constexpr int kSolNT = kFacNT;   // threads of a left-solve block (fac_stage)
constexpr int kSolPanel = 32;    // columns of one substitution panel
constexpr int kRhsChunk = 64;    // most rhs columns per block

// Row stride of the staged tile: whole 16-byte words past round4(nb) (the
// forward product reads a row 4 entries at a time, up to round4(kv)), an
// odd number of them, so that eight neighbouring rows read 16 bytes each
// touch every bank once.
template <typename T>
inline __host__ __device__ int sol_ldm(int nb) {
  constexpr int V = FacVec<T>::V;
  int ld = fac_round4(nb);
  if ((ld / V) % 2 == 0) ld += V;
  return ld;
}

// shared memory of left_solve_tile for zcap = min(kRhsChunk, nrhs)
// columns: the chunk [nb][round4(zcap)] and, in_smem, the tile [nb][ldm]
template <typename T>
inline size_t left_solve_smem(int nb, int zcap, bool in_smem) {
  size_t z = (size_t)nb * fac_round4(zcap) * sizeof(T);
  return in_smem ? z + (size_t)nb * sol_ldm<T>(nb) * sizeof(T) : z;
}

// The panel's pb x pb diagonal block (pb <= kSolPanel) at (j0, j0), for
// the rhs columns warp, warp + nw, ... (at most CW of them) of zs: lane l
// holds row j0 + l of the block (forward) or column j0 + l (transpose) in
// registers and the reciprocal of its pivot; lanes >= pb an identity row
// and a zero rhs.  VM: the tile's rows take 16-byte reads.
template <typename T, int CW, bool VM>
__device__ __forceinline__ void sol_diag_warp(const T* m, int ldm, T* zs,
                                              int rcs, int j0, int pb,
                                              int rc, int nw, bool transpose,
                                              int lane, int warp) {
  constexpr int P = kSolPanel;
  T mv[P];
#pragma unroll
  for (int j = 0; j < P; ++j) mv[j] = T(0);
  T rinv = T(1);
  if (lane < pb) {
    if (transpose) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (j < pb) mv[j] = m[(size_t)(j0 + j) * ldm + j0 + lane];
    } else {
      const T* row = m + (size_t)(j0 + lane) * ldm + j0;
      if (VM) {
#pragma unroll
        for (int g = 0; g < P / 4; ++g) {
          if (4 * g < pb) {
            const Vec4<T> a = fac_load4(row + 4 * g);
#pragma unroll
            for (int u = 0; u < 4; ++u) mv[4 * g + u] = a.v[u];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j)
          if (j < pb) mv[j] = row[j];
      }
    }
    rinv = fac_rcp(m[(size_t)(j0 + lane) * ldm + j0 + lane]);
  }
  // only the strict lower (forward) / upper (transpose) part is used
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j >= pb || (transpose ? j <= lane : j >= lane)) mv[j] = T(0);
  T z[CW];
#pragma unroll
  for (int q = 0; q < CW; ++q) {
    const int c = warp + q * nw;
    z[q] = (lane < pb && c < rc) ? zs[(j0 + lane) * rcs + c] : T(0);
  }
  if (!transpose) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
#pragma unroll
      for (int q = 0; q < CW; ++q) {
        if (lane == j) z[q] *= rinv;
        const T y = __shfl_sync(kFull, z[q], j);
        z[q] -= mv[j] * y;
      }
    }
  } else {
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
#pragma unroll
      for (int q = 0; q < CW; ++q) {
        if (lane == j) z[q] *= rinv;
        const T y = __shfl_sync(kFull, z[q], j);
        z[q] -= mv[j] * y;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CW; ++q) {
    const int c = warp + q * nw;
    if (lane < pb && c < rc) zs[(j0 + lane) * rcs + c] = z[q];
  }
}

template <typename T, bool VM>
__device__ __forceinline__ void sol_diag(const T* m, int ldm, T* zs,
                                         int rcs, int j0, int pb, int rc,
                                         bool transpose, int tid) {
  constexpr int NW = kSolNT / 32;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = rc < NW ? rc : NW;
  if (warp >= nw) return;
  const int cw = (rc + nw - 1) / nw;
  if (cw == 1)
    sol_diag_warp<T, 1, VM>(m, ldm, zs, rcs, j0, pb, rc, nw, transpose,
                            lane, warp);
  else if (cw == 2)
    sol_diag_warp<T, 2, VM>(m, ldm, zs, rcs, j0, pb, rc, nw, transpose,
                            lane, warp);
  else if (cw <= 4)
    sol_diag_warp<T, 4, VM>(m, ldm, zs, rcs, j0, pb, rc, nw, transpose,
                            lane, warp);
  else
    sol_diag_warp<T, kRhsChunk / NW, VM>(m, ldm, zs, rcs, j0, pb, rc, nw,
                                         transpose, lane, warp);
}

// Rows [r0, r1) of zs -= (forward) m[i, j0:j0+pb] * zs[j0:j0+pb] or
// (transpose) m[j0:j0+pb, i]^T * zs[j0:j0+pb].  An item is TR rows and 4
// columns of the output; where there are fewer items than threads, sp
// neighbouring lanes split the contraction (in groups of 4 steps) and sum
// it with shuffles.  Forward reads a row of m 4 entries at a time when VM
// (entries past pb are read, as the tile's rows hold them, and not used);
// transpose reads 4 rows i at a time when VM.
template <typename T, int TR, bool VM>
__device__ __forceinline__ void sol_apply_tr(const T* m, int ldm, T* zs,
                                             int rcs, int j0, int pb, int r0,
                                             int r1, int rc, bool transpose,
                                             int tid) {
  const int cq = (rc + 3) >> 2;
  const int items = (r1 - r0 + TR - 1) / TR * cq;
  const int ngrp = (pb + 3) >> 2;      // contraction groups of 4 steps
  int sp = 1;
  while (sp < 32 && items * sp * 2 <= kSolNT && sp * 2 <= ngrp) sp <<= 1;
  const int part = tid & (sp - 1);
  for (int e0 = 0; e0 < items * sp; e0 += kSolNT) {   // uniform in the block
    const int e = (e0 + tid) / sp;
    const bool live = e < items;
    const int i0 = r0 + (live ? e / cq : 0) * TR;
    const int c = live ? 4 * (e % cq) : 0;
    T acc[TR][4];
#pragma unroll
    for (int t = 0; t < TR; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = T(0);
    if (live) {
      // rows past r1 read row r1 - 1 and are dropped
      int ri[TR];
#pragma unroll
      for (int t = 0; t < TR; ++t) ri[t] = min(i0 + t, r1 - 1);
      for (int g = part; g < ngrp; g += sp) {
        const int jb = 4 * g;
        Vec4<T> zr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          zr[u] = fac_load4(zs + (j0 + min(jb + u, pb - 1)) * rcs + c);
        T a[TR][4];
        if (!transpose) {
#pragma unroll
          for (int t = 0; t < TR; ++t) {
            const T* mr = m + (size_t)ri[t] * ldm + j0 + jb;
            if (VM) {
              const Vec4<T> v = fac_load4(mr);
#pragma unroll
              for (int u = 0; u < 4; ++u) a[t][u] = v.v[u];
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u)
                a[t][u] = jb + u < pb ? mr[u] : T(0);
            }
          }
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const T* mr =
                m + (size_t)(j0 + min(jb + u, pb - 1)) * ldm + i0;
            if (VM && TR == 4 && i0 + 3 < r1) {
              const Vec4<T> v = fac_load4(mr);
#pragma unroll
              for (int t = 0; t < TR; ++t) a[t][u] = v.v[t];
            } else {
#pragma unroll
              for (int t = 0; t < TR; ++t) a[t][u] = mr[ri[t] - i0];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (jb + u < pb) {
#pragma unroll
            for (int t = 0; t < TR; ++t)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[t][q] += a[t][u] * zr[u].v[q];
          }
        }
      }
    }
    for (int off = 1; off < sp; off <<= 1)
#pragma unroll
      for (int t = 0; t < TR; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[t][q] += __shfl_xor_sync(kFull, acc[t][q], off);
    if (live && part == 0) {
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        if (i0 + t < r1) {
          T* zi = zs + (i0 + t) * rcs + c;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < rc) zi[q] -= acc[t][q];
        }
      }
    }
  }
}

// TR by the number of outputs: 4 rows a thread where that still gives
// every thread an item, else 2, else 1 (and the contraction split)
template <typename T, bool VM>
__device__ __forceinline__ void sol_apply(const T* m, int ldm, T* zs,
                                          int rcs, int j0, int pb, int r0,
                                          int r1, int rc, bool transpose,
                                          int tid) {
  const int cq = (rc + 3) >> 2, rows = r1 - r0;
  if ((rows + 3) / 4 * cq >= kSolNT)
    sol_apply_tr<T, 4, VM>(m, ldm, zs, rcs, j0, pb, r0, r1, rc, transpose,
                           tid);
  else if ((rows + 1) / 2 * cq >= kSolNT)
    sol_apply_tr<T, 2, VM>(m, ldm, zs, rcs, j0, pb, r0, r1, rc, transpose,
                           tid);
  else
    sol_apply_tr<T, 1, VM>(m, ldm, zs, rcs, j0, pb, r0, r1, rc, transpose,
                           tid);
}

template <typename T, bool VM>
__device__ __forceinline__ void sol_panels(const T* m, int ldm, T* zs,
                                           int rcs, int kv, int nb, int rc,
                                           bool transpose, int tid) {
  constexpr int P = kSolPanel;
  if (!transpose) {
    for (int j0 = 0; j0 < kv; j0 += P) {
      const int pb = min(P, kv - j0);
      sol_diag<T, VM>(m, ldm, zs, rcs, j0, pb, rc, false, tid);
      __syncthreads();
      if (j0 + pb < nb) {
        sol_apply<T, VM>(m, ldm, zs, rcs, j0, pb, j0 + pb, nb, rc, false,
                         tid);
        __syncthreads();
      }
    }
  } else {
    if (kv > 0 && kv < nb) {
      // fold the pass-through rows >= kv into the rows < kv
      sol_apply<T, VM>(m, ldm, zs, rcs, kv, nb - kv, 0, kv, rc, true, tid);
      __syncthreads();
    }
    for (int j0 = (kv - 1) / P * P; kv > 0 && j0 >= 0; j0 -= P) {
      const int pb = min(P, kv - j0);
      sol_diag<T, VM>(m, ldm, zs, rcs, j0, pb, rc, true, tid);
      __syncthreads();
      if (j0 > 0) {
        sol_apply<T, VM>(m, ldm, zs, rcs, j0, pb, 0, j0, rc, true, tid);
        __syncthreads();
      }
    }
  }
}

// One block (kSolNT threads) solves the chunk of rc columns; zcap: the
// widest chunk of the launch.  in_smem: the tile is staged in shared
// memory (else read from global memory, where it is only read).
template <typename T>
__device__ __forceinline__ void left_solve_tile(
    const T* __restrict__ tile, const T* zin, T* y0, int kv, int nb, int rc,
    int ldz, int zcap, int transpose, int in_smem, unsigned char* smem_raw,
    int tid) {
  constexpr int V = FacVec<T>::V;
  using VT = typename FacVec<T>::type;
  const int rcs = fac_round4(zcap);
  T* zs = reinterpret_cast<T*>(smem_raw);          // [nb][rcs]
  const bool zvec = (ldz * sizeof(T)) % 16 == 0 &&
                    (rc * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<size_t>(zin) % 16 == 0 &&
                    reinterpret_cast<size_t>(y0) % 16 == 0;
  const bool pvec = (nb * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<size_t>(tile) % 16 == 0;
  fac_stage(zs, rcs, zin, ldz, nb, rc, false, zvec, tid);
  const T* m = tile;
  int ldm = nb;
  if (in_smem) {
    T* ms = zs + nb * rcs;
    ldm = sol_ldm<T>(nb);
    // the lower trapezoid of the first kv columns (whole 16-byte words:
    // within the row; what lies above the diagonal is never used)
    fac_stage(ms, ldm, tile, nb, nb, kv, true, pvec, tid);
    m = ms;
  }
  fac_cp_wait_all();
  __syncthreads();

  // VM: rows of m take 16-byte reads (in shared memory they always do)
  if (in_smem || (pvec && nb % 4 == 0))
    sol_panels<T, true>(m, ldm, zs, rcs, kv, nb, rc, transpose, tid);
  else
    sol_panels<T, false>(m, ldm, zs, rcs, kv, nb, rc, transpose, tid);

  if (zvec) {
    const int cv = rc / V;
    for (int e = tid; e < nb * cv; e += kSolNT) {
      const int i = e / cv, q = e - i * cv;
      *reinterpret_cast<VT*>(y0 + (size_t)i * ldz + q * V) =
          *reinterpret_cast<const VT*>(zs + i * rcs + q * V);
    }
  } else {
    for (int e = tid; e < nb * rc; e += kSolNT) {
      const int i = e / rc, r = e - i * rc;
      y0[(size_t)i * ldz + r] = zs[i * rcs + r];
    }
  }
}

}  // namespace spllt
