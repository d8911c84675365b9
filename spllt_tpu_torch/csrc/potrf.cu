// Batched masked bordered Cholesky of nb x nb tiles (Hopper, sm_90a).
//
// Replaces the TPU kernel spllt_tpu/numeric/pallas_potrf.py
// (pallas_potrf_batch / potrf_tiles_body).  For every tile, with kv factor
// columns:  out = [[chol(D), 0], [B * chol(D)^-T, 0]]  where D is the lower
// triangle of the leading kv x kv block and B the rows >= kv of the first kv
// columns.  Rows >= kv are simply "rows below" of a right-looking
// elimination over the columns j < kv, so one loop does the potrf and the
// trailing trsm.
//
// Bound: bytes on the leaf levels (thousands of tiles with a handful of
// factor columns: each tile is written once and only its columns < kv are
// read), operations elsewhere, and there the dependent chain of the kv
// columns of a tile.  One thread block per tile; the batch supplies the
// parallelism across the SMs.  The working tile lives in shared memory when
// it fits the 227 KB a block may use (nb = 128 in float or double),
// otherwise the elimination runs in place on the output tile in global
// memory, which stays in L2.  The columns go in panels of 8 to shorten the
// chain: warp 0 factors the 8 x 8 diagonal block, rows as lanes, with
// shuffles; then every row below solves its 8 panel entries against that
// block in registers; then all warps apply the rank-8 update to the
// trapezoid right of the panel.  Three block barriers per 8 columns.  A
// non-positive (or NaN) pivot marks the tile as failed and the whole output
// tile becomes NaN, which is what the caller's not-positive-definite guard
// looks for.  The elimination itself is potrf_tile in potrf_body.cuh, which
// the factor stream kernel (mega_factor.cu) runs too.
#include "potrf_body.cuh"

namespace {

using namespace spllt;

template <typename T>
__global__ void potrf_kernel(const T* __restrict__ in, T* __restrict__ out,
                             const int* __restrict__ kvec, int nb,
                             int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t off = (size_t)blockIdx.x * nb * nb;
  potrf_tile<T>(in + off, out + off, kvec[blockIdx.x], nb, in_smem, smem_raw,
                threadIdx.x, blockDim.x);
}

template <typename T>
int launch(const void* in, void* out, const int* kvec, int k, int nb,
           void* stream) {
  if (k <= 0) return 0;
  int in_smem = potrf_smem<T>(nb, true) <= (size_t)kMaxSmem;
  size_t smem = potrf_smem<T>(nb, in_smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        potrf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = nb >= 128 ? 512 : (nb >= 32 ? 256 : 64);
  potrf_kernel<T><<<k, threads, smem, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, kvec, nb, in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spllt_potrf_f32(const void* in, void* out, const int* kvec,
                               int k, int nb, void* stream) {
  return launch<float>(in, out, kvec, k, nb, stream);
}
extern "C" int spllt_potrf_f64(const void* in, void* out, const int* kvec,
                               int k, int nb, void* stream) {
  return launch<double>(in, out, kvec, k, nb, stream);
}
