// Batched right triangular solve  dst <- dst * L^-T  (Hopper, sm_90a).
//
// Replaces the TPU kernel spllt_tpu/numeric/pallas_trsm.py
// (pallas_trsm_batch / trsm_tiles_body).  For every (diag, dst) pair with kv
// factor columns, L is the leading kv x kv lower triangle of the diag tile
// that potrf wrote; output columns >= kv are zero.  Rows >= kv of the diag
// tile hold B*L^-T values of the bordered potrf and are never read.
//
// Bound: bytes by the count (three tiles moved for nb * kv^2 operations),
// in practice the dependent chain of kv column steps.  The rows of dst are
// independent (row r solves x L^T = d_r), so each dst row goes to ONE thread
// and there is no barrier inside the substitution: a block of up to 128
// threads takes that many rows of one pair (all of them at nb = 128 in
// float), copies its rows of dst (column major, so that the threads of a
// warp touch neighbouring words) and the lower part of the L tile (row
// major) into shared memory, and walks the columns in panels of 8 held in
// registers: the finished columns are eliminated from the panel with
// 16-byte broadcast loads of L (4 contraction steps per load), then the
// 8 x 8 triangle is solved in registers.  When the L tile does not fit in
// shared memory beside the dst rows (nb = 256 in float, the default tile
// size), the same kernel reads L where it lies in global memory: every
// thread of a warp reads the same words, so these are broadcast loads
// through the read-only cache.  The substitution itself is trsm_rows in
// trsm_body.cuh, which the factor stream kernel (mega_factor.cu) runs too.
#include "trsm_body.cuh"

namespace {

using namespace spllt;

template <typename T, bool LSMEM>
__global__ void __launch_bounds__(kTrsmRbMax)
trsm_rows_kernel(const T* __restrict__ diag, const T* __restrict__ dst,
                 T* __restrict__ out, const int* __restrict__ kvec,
                 int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t off = (size_t)blockIdx.x * nb * nb;
  const int rb = blockDim.x;
  trsm_rows<T, LSMEM>(diag + off, dst + off, out + off, kvec[blockIdx.x], nb,
                      blockIdx.y * rb, rb, smem_raw, threadIdx.x, rb);
}

template <typename T>
int launch(const void* diag, const void* dst, void* out, const int* kvec,
           int k, int nb, void* stream) {
  if (k <= 0) return 0;
  int rb, l_in_smem;
  trsm_config<T>(nb, (size_t)kMaxSmem, &rb, &l_in_smem);
  const size_t smem = trsm_smem<T>(nb, rb, l_in_smem);
  auto kernel = l_in_smem ? trsm_rows_kernel<T, true>
                          : trsm_rows_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(k, (nb + rb - 1) / rb);
  kernel<<<grid, rb, smem, (cudaStream_t)stream>>>(
      (const T*)diag, (const T*)dst, (T*)out, kvec, nb);
  return (int)cudaGetLastError();
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
