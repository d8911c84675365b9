// Masked bordered Cholesky of one nb x nb tile by one thread block.
//
// With kv factor columns:  o = [[chol(D), 0], [B * chol(D)^-T, 0]]  where D
// is the lower triangle of the leading kv x kv block of a and B the rows
// >= kv of its first kv columns.  Rows >= kv are simply "rows below" of a
// right-looking elimination over the columns j < kv, so one loop does the
// potrf and the trailing trsm.  The columns go in panels of 8: warp 0
// factors the 8 x 8 diagonal block, rows as lanes, with shuffles; then
// every row below solves its 8 panel entries against that block in
// registers; then all warps apply the rank-8 update to the trapezoid right
// of the panel.  Three block barriers per 8 columns.  A non-positive (or
// NaN) pivot marks the tile as failed and the whole output tile becomes
// NaN, which is what the caller's not-positive-definite guard looks for.
//
// The working tile lives in shared memory (in_smem) or the elimination
// runs in place on the output tile in global memory.  a and o may be the
// same tile (the stream kernel factors in place on the pool); neither is
// read through the read-only path here.
#pragma once
#include "common.cuh"

namespace spllt {

constexpr int kPotrfP = 8;   // panel width

// shared memory of potrf_tile: panel + diagonal block + flag, and the
// padded working tile when it is kept in shared memory
template <typename T>
inline size_t potrf_smem(int nb, bool in_smem) {
  size_t small = (size_t)(kPotrfP * nb + kPotrfP * kPotrfP + 4) * sizeof(T);
  return in_smem ? small + (size_t)nb * (nb + 1) * sizeof(T) : small;
}

// Ends with every thread's writes to o made; the caller puts a block
// barrier before the shared memory is used again.
template <typename T>
__device__ __forceinline__ void potrf_tile(const T* a, T* o, int kv, int nb,
                                           int in_smem,
                                           unsigned char* smem_raw, int tid,
                                           int nt) {
  constexpr int P = kPotrfP;
  T* pan = reinterpret_cast<T*>(smem_raw);   // [P][nb] solved panel, by column
  T* dd = pan + P * nb;                      // [P][P] factored diagonal block
  int* sbad = reinterpret_cast<int*>(dd + P * P);
  T* w = in_smem ? dd + P * P + 4 : o;       // 4 elements hold the flag
  // padded rows in shared memory keep column reads off one bank
  const int ld = in_smem ? nb + 1 : nb;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;

  if (tid == 0) *sbad = 0;
  // masked lower seed: columns < kv, rows >= column (nothing else is read
  // during the elimination)
  for (int idx = tid; idx < nb * kv; idx += nt) {
    const int i = idx / kv, c = idx - i * kv;
    if (i >= c) w[i * ld + c] = a[i * nb + c];
  }
  __syncthreads();

  for (int j0 = 0; j0 < kv; j0 += P) {
    const int pw = min(P, kv - j0);
    // ---- diagonal block: warp 0, lane l holds row j0 + l ---------------- //
    if (warp == 0) {
      T d[P];
#pragma unroll
      for (int jj = 0; jj < P; ++jj)
        d[jj] = (lane < pw && jj <= lane) ? w[(j0 + lane) * ld + j0 + jj]
                                          : T(0);
      bool bad = false;
#pragma unroll
      for (int jj = 0; jj < P; ++jj) {
        if (jj < pw) {
          const T piv = __shfl_sync(kFull, d[jj], jj);
          bad |= !(piv > T(0));            // catches <= 0 and NaN
          const T s = sqrt(piv);
          d[jj] = lane == jj ? s : d[jj] / s;
#pragma unroll
          for (int c = jj + 1; c < P; ++c) {
            const T lc = __shfl_sync(kFull, d[jj], c);
            if (lane >= c) d[c] -= d[jj] * lc;
          }
        }
      }
      if (lane < pw) {
#pragma unroll
        for (int jj = 0; jj < P; ++jj) {
          dd[lane * P + jj] = d[jj];
          if (jj <= lane) w[(j0 + lane) * ld + j0 + jj] = d[jj];
        }
      }
      if (bad && lane == 0) *sbad = 1;
    }
    __syncthreads();
    // ---- rows below the block: x * Ldd^T = panel row, in registers ------ //
    for (int i = j0 + pw + tid; i < nb; i += nt) {
      T x[P];
#pragma unroll
      for (int jj = 0; jj < P; ++jj)
        x[jj] = jj < pw ? w[i * ld + j0 + jj] : T(0);
#pragma unroll
      for (int jj = 0; jj < P; ++jj) {
        if (jj < pw) {
          T s = x[jj];
#pragma unroll
          for (int q = 0; q < jj; ++q) s -= x[q] * dd[jj * P + q];
          x[jj] = s / dd[jj * P + jj];
        }
      }
#pragma unroll
      for (int jj = 0; jj < P; ++jj) {
        if (jj < pw) w[i * ld + j0 + jj] = x[jj];
        pan[jj * nb + i] = x[jj];
      }
    }
    __syncthreads();
    // ---- rank-pw update of the trapezoid right of the panel ------------- //
    if (j0 + pw < kv) {
      for (int i = j0 + pw + warp; i < nb; i += nwarp) {
        T pi[P];
#pragma unroll
        for (int p = 0; p < P; ++p) pi[p] = pan[p * nb + i];
        const int cend = i < kv - 1 ? i : kv - 1;
        for (int c = j0 + pw + lane; c <= cend; c += 32) {
          T s = T(0);
#pragma unroll
          for (int p = 0; p < P; ++p) s += pi[p] * pan[p * nb + c];
          w[i * ld + c] -= s;
        }
      }
      __syncthreads();
    }
  }

  __syncthreads();
  if (*sbad) {
    // a failed tile is NaN everywhere, as a failed library Cholesky leaves
    // it: the caller's guard reads element [0, 0] of every tile
    const T qnan = sqrt(T(-1));
    for (int idx = tid; idx < nb * nb; idx += nt) o[idx] = qnan;
  } else {
    for (int idx = tid; idx < nb * nb; idx += nt) {
      const int i = idx / nb, c = idx - i * nb;
      o[idx] = (c < kv && i >= c) ? w[i * ld + c] : T(0);
    }
  }
}

}  // namespace spllt
