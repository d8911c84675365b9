// Fused gather-GEMM-accumulate update of the factor pool (Hopper, sm_90a).
//
// Replaces the TPU kernel spllt_tpu/numeric/pallas_update.py
// (pallas_apply_updates / _kernel / onehot_gather).  One launch applies one
// level's update micro-tasks, sorted by destination tile dst[t], to the
// flat pool [rows, nb]; the body (update_compact.cuh) is the one the
// factor stream's UPD runs (mega_factor.cu) launch too.  Here dst names a
// tile, so the destination of task t starts at pool row dst[t] * nb.
// spllt_update_f32 and _f64 multiply in IEEE arithmetic of the pool;
// spllt_update_f32_tf32 on the tensor cores in one TF32 pass (the TPU
// kernel's DEFAULT product).
#include "update_compact.cuh"

// dense: the tables' flag for a level of long chains of near-dense tasks
// (numeric/hopper_update.py dense_level)
extern "C" int spllt_update_f32(void* pool, const int* seg_ptr,
                                const int* dst, const int* lor,
                                const int* loc, const int* srcn,
                                const int* eptr, const int* enr,
                                const int* ent, int nseg, int nb, int dense,
                                void* stream) {
  return spllt::update_launch<float>(pool, seg_ptr, dst, lor, loc, srcn,
                                     eptr, enr, ent, nseg, nb, nb, dense,
                                     stream);
}
extern "C" int spllt_update_f64(void* pool, const int* seg_ptr,
                                const int* dst, const int* lor,
                                const int* loc, const int* srcn,
                                const int* eptr, const int* enr,
                                const int* ent, int nseg, int nb, int dense,
                                void* stream) {
  return spllt::update_launch<double>(pool, seg_ptr, dst, lor, loc, srcn,
                                      eptr, enr, ent, nseg, nb, nb, dense,
                                      stream);
}
extern "C" int spllt_update_f32_tf32(void* pool, const int* seg_ptr,
                                     const int* dst, const int* lor,
                                     const int* loc, const int* srcn,
                                     const int* eptr, const int* enr,
                                     const int* ent, int nseg, int nb,
                                     int dense, void* stream) {
  return spllt::update_launch<float, spllt::kTf32>(
      pool, seg_ptr, dst, lor, loc, srcn, eptr, enr, ent, nseg, nb, nb, dense,
      stream);
}
