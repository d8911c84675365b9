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
// read), operations elsewhere, and there the latency of the dependent
// chain of a tile's kv columns.  One thread block per tile; the batch
// supplies the parallelism across the SMs.  The elimination is potrf_tile
// in potrf_body.cuh, built from the pieces of the factor stream kernel's
// POTRF item (mega_factor_body.cuh): the trapezoid staged by 16-byte
// cp.async.cg, 16-column panels, the diagonal block factored in one warp's
// registers with rsqrt, one thread a row below, register-tiled rank-16
// updates, an identity pad instead of runtime guards.  The working tile
// lives in shared memory when it fits the 227 KB a block may use (nb = 128
// in float or double), otherwise the elimination runs on the output tile
// in global memory, which stays in L2.  A non-positive (or NaN) pivot
// makes the whole output tile NaN, which is what the caller's
// not-positive-definite guard looks for.
#include "potrf_body.cuh"

namespace {

using namespace spllt;

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kFacNT)
    potrf_kernel(const T* __restrict__ in, T* __restrict__ out,
                 const int* __restrict__ kvec, int nb) {
  const size_t off = (size_t)blockIdx.x * nb * nb;
  potrf_tile<T, SMEM>(in + off, out + off, kvec[blockIdx.x], nb,
                      threadIdx.x);
}

template <typename T, bool SMEM>
int launch_as(const void* in, void* out, const int* kvec, int k, int nb,
              size_t smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      potrf_kernel<T, SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  potrf_kernel<T, SMEM><<<k, kFacNT, smem, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, kvec, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, const int* kvec, int k, int nb,
           void* stream) {
  if (k <= 0) return 0;
  const size_t smem = fac_potrf_smem<T>(nb, true);
  if (smem <= (size_t)kMaxSmem)
    return launch_as<T, true>(in, out, kvec, k, nb, smem, stream);
  return launch_as<T, false>(in, out, kvec, k, nb,
                             fac_potrf_smem<T>(nb, false), stream);
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
