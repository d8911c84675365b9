// Shared by every kernel source of spllt_tpu_torch (Hopper, sm_90a).
//
// The elimination routines live once, as __device__ functions in the
// *_body.cuh headers beside this file.  Each takes the thread index, the
// thread count and the base of the block's shared memory as arguments, so
// the standalone batched kernels (potrf.cu, trsm.cu, update.cu, solve.cu:
// one block per item, sized by the launch) and the persistent stream
// kernels (mega_factor.cu, mega_solve.cu: one block size and one
// shared-memory size for all bodies) run the same code.
#pragma once
#include <cuda_runtime.h>

namespace spllt {

// most dynamic shared memory one block may use on sm_90
constexpr int kMaxSmem = 232448;
// most a block may use when two blocks are to share one SM (each block
// also reserves 1 KB of the SM's 228 KB)
constexpr int kHalfSmem = 115712;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct alignas(16) Vec4 { T v[4]; };

// The stream kernels hand out a run's work items through one counter per
// run in global memory (zero at launch): whichever block is free takes the
// next item, so a long item does not hold up the items queued behind it in
// a fixed stride.  The leading barrier also keeps the block's shared memory
// and *slot from being reused while a thread is still in the previous item.
__device__ __forceinline__ int next_item(int* counter, int* slot, int tid) {
  __syncthreads();
  if (tid == 0) *slot = atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

// One cooperative launch of `kernel` with nt threads a block and smem bytes
// of dynamic shared memory: as many blocks as are resident at once on the
// card (every block of a cooperative launch must be), or max_blocks if that
// is positive and fewer.  *grid_out receives the number of blocks.  Returns
// the cudaError_t of the first call that failed; a kernel that cannot be
// resident is cudaErrorCooperativeLaunchTooLarge, never a plain launch.
template <typename Kernel>
inline int launch_cooperative(Kernel kernel, int nt, size_t smem,
                              int max_blocks, int* grid_out, void** args,
                              void* stream) {
  // always: the kernel's few bytes of static shared memory count against
  // the 48 KB a block may use without this opt-in
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, nt,
                                                         smem)) !=
      cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int grid = occ * sms;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  if (grid_out) *grid_out = grid;
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(nt),
                                  args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace spllt
