// Left triangular solve of one rhs chunk against one tile, by one block.
//
// With kv factor columns, m = tile + I on the diagonal of rows >= kv (the
// tile is the masked lower output of potrf: columns >= kv are zero).
// Solves  m y = z  (forward) or  m^T y = z  (transpose) for the nb x rc
// chunk z whose rows lie ldz elements apart.
//   forward:   the kv x kv triangle is solved by substitution; rows >= kv
//              carry real B*L^-T values, so y_i = z_i - sum_j m[i,j] y_j
//              applies the below-row update in passing.
//   transpose: rows >= kv pass through (y_i = z_i) and are first folded
//              into the rows < kv through m[i, :kv]^T; then the triangle is
//              solved backwards.
// The tile is copied once, coalesced, into shared memory with padded rows
// (so both row and column walks are conflict free) when in_smem is set,
// otherwise it is read from global memory.  The rhs chunk lives in shared
// memory and turns into y in place; the rectangular part (rows >= kv) is
// one pass without barriers, the triangle takes two barriers per column.
// y is written to y0; z may be y0: the chunk is read whole before anything
// is written.
#pragma once
#include "common.cuh"

namespace spllt {

constexpr int kRhsChunk = 64;   // most rhs columns per block

// shared memory of left_solve_tile for zcap = min(kRhsChunk, nrhs) columns
template <typename T>
inline size_t left_solve_smem(int nb, int zcap, bool in_smem) {
  size_t z = (size_t)nb * zcap * sizeof(T);
  return in_smem ? z + (size_t)nb * (nb + 1) * sizeof(T) : z;
}

// Ends with every thread's writes made; the caller puts a block barrier
// before the shared memory is used again.
template <typename T>
__device__ __forceinline__ void left_solve_tile(
    const T* tile, const T* zin, T* y0, int kv, int nb, int rc,
    int ldz, int zcap, int transpose, int in_smem, unsigned char* smem_raw,
    int tid, int nt) {
  T* zs = reinterpret_cast<T*>(smem_raw);          // [nb, rc]
  const int ld = in_smem ? nb + 1 : nb;
  const T* m = tile;
  if (in_smem) {
    T* ms = zs + nb * zcap;
    for (int idx = tid; idx < nb * nb; idx += nt) {
      const int i = idx / nb, c = idx - i * nb;
      if (c < kv) ms[i * ld + c] = tile[idx];
    }
    m = ms;
  }
  for (int idx = tid; idx < nb * rc; idx += nt) {
    const int i = idx / rc, r = idx - i * rc;
    zs[idx] = zin[(size_t)i * ldz + r];
  }
  __syncthreads();

  if (!transpose) {
    for (int j = 0; j < kv; ++j) {
      const T piv = m[j * ld + j];
      for (int r = tid; r < rc; r += nt) zs[j * rc + r] /= piv;
      __syncthreads();
      for (int idx = tid; idx < (kv - j - 1) * rc; idx += nt) {
        const int i = j + 1 + idx / rc, r = idx % rc;
        zs[i * rc + r] -= m[i * ld + j] * zs[j * rc + r];
      }
      __syncthreads();
    }
    // rows >= kv: identity diagonal, below-row update from the solved part
    for (int idx = tid; idx < (nb - kv) * rc; idx += nt) {
      const int i = kv + idx / rc, r = idx % rc;
      T acc = zs[i * rc + r];
      for (int j = 0; j < kv; ++j) acc -= m[i * ld + j] * zs[j * rc + r];
      zs[i * rc + r] = acc;
    }
  } else {
    // rows >= kv pass through; fold them into the rows < kv
    for (int idx = tid; idx < kv * rc; idx += nt) {
      const int i = idx / rc, r = idx - i * rc;
      T acc = zs[idx];
      for (int j = kv; j < nb; ++j) acc -= m[j * ld + i] * zs[j * rc + r];
      zs[idx] = acc;
    }
    __syncthreads();
    for (int j = kv - 1; j >= 0; --j) {
      const T piv = m[j * ld + j];
      for (int r = tid; r < rc; r += nt) zs[j * rc + r] /= piv;
      __syncthreads();
      for (int idx = tid; idx < j * rc; idx += nt) {
        const int i = idx / rc, r = idx - i * rc;
        zs[idx] -= m[j * ld + i] * zs[j * rc + r];
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * rc; idx += nt) {
    const int i = idx / rc, r = idx - i * rc;
    y0[(size_t)i * ldz + r] = zs[idx];
  }
}

}  // namespace spllt
