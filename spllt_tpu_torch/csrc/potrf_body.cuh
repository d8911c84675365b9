// Masked bordered Cholesky of one nb x nb tile, out of place, by one block
// of kFacNT threads (the batched potrf kernel, potrf.cu).
//
// With kv factor columns:  out = [[chol(D), 0], [B * chol(D)^-T, 0]]
// where D is the lower triangle of the leading kv x kv block of in and B
// the rows >= kv of its first kv columns.  Rows >= kv are simply "rows
// below" of a right-looking elimination over the columns j < kv, so one
// loop does the potrf and the trailing trsm.
//
// Built as the factor stream kernel's POTRF item (mega_factor_body.cuh),
// from its pieces: the lower trapezoid of the first kv columns is staged
// in shared memory by 16-byte cp.async.cg (ordinary loads where the rows
// do not line up), then panels of 16 columns: warp 0 factors the diagonal block
// in registers (fac_diag_factor: one rsqrt a pivot, lanes past the panel
// an identity row), one thread a row below solves its entries against it
// (fac_rows), and the block applies the rank-16 update to the trapezoid
// right of the panel as a register-tiled product (fac_product); three
// block barriers a panel.  K4 factors in place on the pool; this kernel
// reads `in` and writes `out`, so it has its own copy of that loop and
// K4's POTRF item stays as it is.  A tile that does not fit in shared
// memory (nb = 256 in float32) is first copied to out (its trapezoid) and
// eliminated there, in global memory (L2).  A non-positive (or NaN) pivot
// makes the whole output tile NaN, which is what the caller's
// not-positive-definite guard looks for.
#pragma once
#include "mega_factor_body.cuh"

namespace spllt {

// Shared memory: fac_potrf_smem, as for the stream kernel's POTRF item.
// Ends with every thread's writes to out made.
template <typename T, bool SMEM>
__device__ __forceinline__ void potrf_tile(const T* in, T* out, int kv,
                                           int nb, int tid) {
  constexpr int V = FacVec<T>::V;
  using VT = typename FacVec<T>::type;
  unsigned char* smem_raw = fac_smem;
  int* sbad = reinterpret_cast<int*>(smem_raw);
  T* ltd = reinterpret_cast<T*>(smem_raw + 16);      // [P][P]
  T* pt = ltd + kFacPanel * kFacPanel;               // [P][ldp]
  const int ldp = fac_round4(nb);
  T* w = SMEM ? pt + kFacPanel * ldp : out;
  const int ld = SMEM ? fac_ld<T>(nb) : nb;
  const bool ivec = nb % V == 0 && reinterpret_cast<size_t>(in) % 16 == 0;
  const bool ovec = nb % V == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  const int lane = tid & 31;

  if (tid == 0) *sbad = 0;
  if (SMEM) {
    fac_stage(w, ld, in, nb, nb, kv, true, ivec, tid);
    fac_cp_wait_all();
  } else {
    for (int e = tid; e < nb * kv; e += kFacNT) {
      const int i = e / kv, c = e - i * kv;
      if (c <= i) out[(size_t)i * nb + c] = in[(size_t)i * nb + c];
    }
  }
  __syncthreads();

  for (int j0 = 0; j0 < kv; j0 += kFacPanel) {
    const int pb = min(kFacPanel, kv - j0);
    if (tid < 32 && fac_diag_factor<T, SMEM>(w, ld, j0, pb, ltd, lane) &&
        lane == 0)
      *sbad = 1;
    __syncthreads();
    const int r0 = j0 + pb;
    if (r0 < nb) {
      fac_rows<T, SMEM>(w, ld, r0, nb, j0, pb, ltd, kFacPanel, pt, ldp, tid);
      __syncthreads();
      if (r0 < kv) {
        fac_product<T, SMEM, true>(w, ld, pt, ldp, pt, ldp, pb, r0, nb, r0,
                                   kv, tid);
        __syncthreads();
      }
    }
  }

  // a failed tile is NaN everywhere, as a failed library Cholesky leaves it
  const bool bad = *sbad != 0;
  const T qnan = sqrt(T(-1));
  if (SMEM && ovec) {
    const int cv = nb / V;
    for (int e = tid; e < nb * cv; e += kFacNT) {
      const int i = e / cv, c = (e - i * cv) * V;
      VT v;
      T* pv = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int u = 0; u < V; ++u)
        pv[u] = bad ? qnan
                    : (c + u < kv && c + u <= i) ? w[i * ld + c + u] : T(0);
      *reinterpret_cast<VT*>(out + (size_t)i * nb + c) = v;
    }
  } else {
    for (int e = tid; e < nb * nb; e += kFacNT) {
      const int i = e / nb, c = e - i * nb;
      out[e] = bad ? qnan : (c < kv && c <= i) ? w[i * ld + c] : T(0);
    }
  }
}

}  // namespace spllt
