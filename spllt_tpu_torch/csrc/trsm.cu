// Batched right triangular solve  dst <- dst * L^-T  (Hopper, sm_90a).
//
// Replaces the TPU kernel spllt_tpu/numeric/pallas_trsm.py
// (pallas_trsm_batch / trsm_tiles_body).  For every (diag, dst) pair with kv
// factor columns, L is the leading kv x kv lower triangle of the diag tile
// that potrf wrote; output columns >= kv are zero.  Rows >= kv of the diag
// tile hold B*L^-T values of the bordered potrf and are never read.
//
// Bound: bytes by the count (three tiles moved for nb * kv^2 operations);
// in practice the latency of the dependent chain of kv column steps, since
// most levels of a factorization have fewer pairs than the card has SMs.
// So the design is the factor stream kernel's TRSM item
// (mega_factor_body.cuh, built from its helpers, which stay unchanged):
// one block of kFacNT threads takes a band of 16, 32 or 64 dst rows of one
// pair (band_rows: the fewer pairs a launch has, the narrower its bands,
// so that a level with few pairs spreads over more blocks), stages L's
// lower triangle, transposed, with the reciprocal of each pivot on its
// diagonal (fac_stage + fac_mirror) and its dst rows (16-byte cp.async.cg
// where the rows line up) in shared memory, and eliminates in panels of 16
// columns: one thread a row solves the panel against L^T in registers
// (fac_rows, no barrier inside), then the block updates the columns right
// of the panel with a register-tiled rank-16 product (fac_product).  Two
// block barriers a panel.  Where L^T does not fit in shared memory beside
// the rows (nb = 256 in float32 and float64) it is staged a panel at a
// time (fac_stage_lt).  The stream kernel works in place on the pool; this
// kernel reads dst and writes out, so trsm_band is its own copy of that
// item's loop.  Every value is summed in a fixed order whatever the band.
#include <algorithm>

#include "mega_factor_body.cuh"

namespace {

using namespace spllt;

// Rows of a band: 16, 32 or 64, the narrowest that keeps the launch
// within kBandBlocks blocks (two an SM).  numeric/hopper_trsm.py
// trsm_band_rows is the same rule.
constexpr int kBandBlocks = 264;

int band_rows(int k, int nb) {
  const long long items =
      (long long)k * ((nb + kTrsmItemRows - 1) / kTrsmItemRows);
  return 4 * items <= kBandBlocks   ? kTrsmItemRows / 4
         : 2 * items <= kBandBlocks ? kTrsmItemRows / 2
                                    : kTrsmItemRows;
}

// Rows [r0, r0 + m) of one pair: in -> out, m <= rows (the band's size,
// which sized the shared memory).
template <typename T, bool LSMEM>
__device__ __forceinline__ void trsm_band(const T* l, const T* in, T* out,
                                          int kv, int nb, int r0, int m,
                                          int rows, int tid) {
  unsigned char* smem_raw = fac_smem;
  constexpr int V = FacVec<T>::V;
  using VT = typename FacVec<T>::type;
  const int ldt = fac_ldt(nb), ldp = fac_round4(rows);
  const int ldx = fac_ld<T>(nb);
  T* lt = reinterpret_cast<T*>(smem_raw);      // [nb or P][ldt]
  T* pt = lt + (size_t)(LSMEM ? fac_panels(nb) : kFacPanel) * ldt;
  T* xr = pt + kFacPanel * ldp;                // [rows][ldx]
  const bool gvec = nb % V == 0 && reinterpret_cast<size_t>(l) % 16 == 0 &&
                    reinterpret_cast<size_t>(in) % 16 == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0;
  const T* src = in + (size_t)r0 * nb;
  T* dst = out + (size_t)r0 * nb;

  // L row-major into lt's rows, then mirrored into its upper half
  if (LSMEM) fac_stage(lt, ldt, l, nb, kv, kv, true, gvec, tid);
  fac_stage(xr, ldx, src, nb, m, kv, false, gvec, tid);
  fac_cp_wait_all();
  __syncthreads();
  if (LSMEM) {
    fac_mirror(lt, ldt, kv, tid);
    __syncthreads();
  }
  for (int j0 = 0; j0 < kv; j0 += kFacPanel) {
    const int pb = min(kFacPanel, kv - j0);
    if (!LSMEM) {     // the last panel's product ended with a barrier
      fac_stage_lt(lt, ldt, l, nb, kv, j0, pb, j0, gvec, tid);
      __syncthreads();
    }
    const T* lp = LSMEM ? lt + (size_t)j0 * ldt : lt;   // row p: L[:, j0+p]
    fac_rows<T, true>(xr, ldx, 0, m, j0, pb, lp + j0, ldt, pt, ldp, tid);
    __syncthreads();
    if (j0 + pb < kv) {
      if (m <= 16)
        fac_product<T, true, false, 16>(xr, ldx, pt, ldp, lp, ldt, pb, 0, m,
                                        j0 + pb, kv, tid);
      else if (m <= 32)
        fac_product<T, true, false, 32>(xr, ldx, pt, ldp, lp, ldt, pb, 0, m,
                                        j0 + pb, kv, tid);
      else
        fac_product<T, true, false>(xr, ldx, pt, ldp, lp, ldt, pb, 0, m,
                                    j0 + pb, kv, tid);
      __syncthreads();
    }
  }
  if (gvec) {
    const int cv = nb / V;
    for (int e = tid; e < m * cv; e += kFacNT) {
      const int i = e / cv, c = (e - i * cv) * V;
      VT v;
      T* pv = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int u = 0; u < V; ++u)
        pv[u] = c + u < kv ? xr[i * ldx + c + u] : T(0);
      *reinterpret_cast<VT*>(dst + (size_t)i * nb + c) = v;
    }
  } else {
    for (int e = tid; e < m * nb; e += kFacNT) {
      const int i = e / nb, c = e - i * nb;
      dst[e] = c < kv ? xr[i * ldx + c] : T(0);
    }
  }
}

template <typename T, bool LSMEM>
__global__ void __launch_bounds__(kFacNT)
    trsm_kernel(const T* __restrict__ diag, const T* __restrict__ dst,
                T* __restrict__ out, const int* __restrict__ kvec, int nb,
                int rows) {
  const size_t off = (size_t)blockIdx.x * nb * nb;
  const int r0 = blockIdx.y * rows;
  trsm_band<T, LSMEM>(diag + off, dst + off, out + off, kvec[blockIdx.x], nb,
                      r0, min(rows, nb - r0), rows, threadIdx.x);
}

template <typename T, bool LSMEM>
int launch_as(const void* diag, const void* dst, void* out, const int* kvec,
              int k, int nb, int rows, size_t smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      trsm_kernel<T, LSMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(k, (nb + rows - 1) / rows);
  trsm_kernel<T, LSMEM><<<grid, kFacNT, smem, (cudaStream_t)stream>>>(
      (const T*)diag, (const T*)dst, (T*)out, kvec, nb, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* diag, const void* dst, void* out, const int* kvec,
           int k, int nb, void* stream) {
  if (k <= 0) return 0;
  const int rows = std::min(band_rows(k, nb), nb);
  const size_t smem = fac_trsm_smem<T>(nb, rows, true);
  if (smem <= (size_t)kMaxSmem)
    return launch_as<T, true>(diag, dst, out, kvec, k, nb, rows, smem,
                              stream);
  const size_t part = fac_trsm_smem<T>(nb, rows, false);
  if (part > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_as<T, false>(diag, dst, out, kvec, k, nb, rows, part, stream);
}

}  // namespace

extern "C" int spllt_trsm_f32(const void* diag, const void* dst, void* out,
                              const int* kvec, int k, int nb, void* stream) {
  return launch<float>(diag, dst, out, kvec, k, nb, stream);
}
extern "C" int spllt_trsm_f64(const void* diag, const void* dst, void* out,
                              const int* kvec, int k, int nb, void* stream) {
  return launch<double>(diag, dst, out, kvec, k, nb, stream);
}
