// Batched left triangular solve of rhs panels (Hopper, sm_90a).
//
// Replaces the TPU kernel spllt_tpu/numeric/pallas_solve.py
// (pallas_left_solve / solve_tiles_body).  Per tile with kv factor columns,
// m = tile + I on the diagonal of rows >= kv (the tile is the masked lower
// output of potrf: columns >= kv are zero).  Solves  m y = z  (forward) or
// m^T y = z  (transpose) for z [nb, nrhs].
//   forward:   the kv x kv triangle is solved by substitution; rows >= kv
//              carry real B*L^-T values, so y_i = z_i - sum_j m[i,j] y_j
//              applies the below-row update in passing.
//   transpose: rows >= kv pass through (y_i = z_i) and are first folded
//              into the rows < kv through m[i, :kv]^T; then the triangle is
//              solved backwards.
//
// Bound: bytes at small nrhs (each tile is read once for 2*nb*kv*nrhs
// operations); a dependent chain of kv steps per tile.  Design: one thread
// block per (tile, chunk of up to 64 rhs columns); the tile is copied once,
// coalesced, into shared memory with padded rows (so both row and column
// walks are conflict free) when it fits beside the rhs chunk, otherwise it
// is read from global memory.  The rhs chunk lives in shared memory and
// turns into y in place; the rectangular part (rows >= kv) is one pass
// without barriers, the triangle takes two barriers per column.  The solve
// itself is left_solve_tile in solve_body.cuh, which the solve stream kernel
// (mega_solve.cu) runs too.
#include "solve_body.cuh"

namespace {

using namespace spllt;

template <typename T>
__global__ void left_solve_kernel(const T* __restrict__ tiles,
                                  const T* __restrict__ z, T* __restrict__ y,
                                  const int* __restrict__ kvec, int nb,
                                  int nrhs, int transpose, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c0 = blockIdx.y * kRhsChunk;
  const size_t zoff = (size_t)blockIdx.x * nb * nrhs + c0;
  left_solve_tile<T>(tiles + (size_t)blockIdx.x * nb * nb, z + zoff, y + zoff,
                     (T*)nullptr, kvec[blockIdx.x], nb,
                     min(kRhsChunk, nrhs - c0), nrhs, min(kRhsChunk, nrhs),
                     transpose, in_smem, smem_raw, threadIdx.x, blockDim.x);
}

template <typename T>
int launch(const void* tiles, const void* z, void* y, const int* kvec, int k,
           int nb, int nrhs, int transpose, void* stream) {
  if (k <= 0 || nrhs <= 0) return 0;
  const int zcap = nrhs < kRhsChunk ? nrhs : kRhsChunk;
  int in_smem = left_solve_smem<T>(nb, zcap, true) <= (size_t)kMaxSmem;
  size_t smem = left_solve_smem<T>(nb, zcap, in_smem);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        left_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(k, (nrhs + kRhsChunk - 1) / kRhsChunk);
  int threads = nb >= 64 ? 256 : 64;
  left_solve_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)tiles, (const T*)z, (T*)y, kvec, nb, nrhs, transpose,
      in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spllt_left_solve_f32(const void* tiles, const void* z, void* y,
                                    const int* kvec, int k, int nb, int nrhs,
                                    int transpose, void* stream) {
  return launch<float>(tiles, z, y, kvec, k, nb, nrhs, transpose, stream);
}
extern "C" int spllt_left_solve_f64(const void* tiles, const void* z, void* y,
                                    const int* kvec, int k, int nb, int nrhs,
                                    int transpose, void* stream) {
  return launch<double>(tiles, z, y, kvec, k, nb, nrhs, transpose, stream);
}
