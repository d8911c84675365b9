// The compact update body (Hopper, sm_90a): the batched update kernel
// (update.cu, K3) and the UPD runs of the factor stream (mega_factor.cu, K4)
// launch the one kernel below.
//
// The flat pool is [rows, nb].  Micro-task t, sorted by destination:
//   R[i, :] = pool[lor[t] + relr[t, i], :srcn[t]]  (zero when relr < 0)
//   C[j, :] = pool[loc[t] + relc[t, j], :srcn[t]]  (zero when relc < 0 or
//                                                   j >= blkn[t])
//   D -= R * C^T, D the nb x nb tile at row dst[t] * drows of the pool
// (drows = nb where dst names a tile, as in K3's tables; 1 where it is a
// row base, as in the factor stream's).  Tasks with equal dst form one
// segment.  Within one launch no destination tile is also a source, so
// updating in place is safe.
//
// Bound: bytes by the count of what the live rows and columns need (each
// gathered source entry read once, each destination tile read and written
// once); in practice the time goes to the arithmetic over the live rows
// and columns and, on the levels of tiny tasks, to each task's latency.
// Most micro-tasks are sparse: a few dozen live rows and columns of a
// 128-row tile.  So the host packs, once per pattern
// (numeric/hopper_update.py pack_live_entries), each task's live rows, then
// its live columns, as int32 entries  (destination index << 16) | window-
// relative source row,  and flags a task whose next task has the same
// destination and the same live rows and columns (one update split over
// source block columns).  The kernel multiplies only the live rows and
// columns: one thread block per destination segment walks its tasks in
// units (a task, or a 16 TM x 16 TM sub-tile of one with more live rows or
// columns), and per unit
//   - copies the live source rows into shared memory with 16-byte
//     cp.async.cg (zero-filled past srcn), kKC contraction columns a stage,
//     kStages stages in flight in a ring that runs on from unit to unit:
//     the next unit's first stages (and, at a task's start, the task after
//     it's entries) are issued during the current unit's last stage;
//   - multiplies them as a register-tiled product over the compact rows and
//     columns (256 threads as 16 x 16, thread (ty, tx) owns compact rows
//     ty + 16u and columns tx + 16v, TM x TM at most: 8 x 8 in float, 4 x 4
//     in double), instantiated for the number of 16-column groups, with the
//     row groups tested at run time unless all are live, so the arithmetic
//     covers the live rows and columns rounded up to 16 and srcn rounded up
//     to 4;
//   - keeps the sums in registers while the next task is flagged, else
//     subtracts them from the destination tile in place at the live cells
//     the entries name (each cell of a unit belongs to one thread), while
//     the next unit's stages are in flight.
// The product comes in two variants (template parameter P): kIeee, the
// float or double FMA product above; for float pools also kTf32, the
// counterpart of the TPU kernel's one-pass DEFAULT product
// (spllt_tpu/numeric/megakernel.py _kernel), on the tensor cores with
// mma.sync.m16n8k8.tf32: the 8 warps share the unit's 16 x 16 tiles of
// live rows and columns (tile w + 8 q to warp w, q < NV), each a 16 x 8
// mma pair per 8 contraction columns, the operands rounded to TF32 with
// cvt.rna where the fragments are loaded from the stages, each step's
// products summed from zero by the tensor core and added to the sums in
// float.  (The TPU's three-pass HIGH has no variant here: the IEEE float
// product is as accurate as TF32x3 and no slower on the H100.)  The
// stages, the ring, the chains and the entries are the same; the fragments
// of the stage rows (stride LD = 20 floats) reach 32 distinct banks.  Each
// live cell is still owned by one thread (rows g, g + 8, columns 2 t,
// 2 t + 1 of each 16 x 8 tile).  The arithmetic covers the live rows and
// columns rounded up to 16 and srcn rounded up to 8.
// Two blocks share an SM, so that one block's latency is hidden by the
// other's work; a launch of long chains of near-dense tasks (the host's
// dense flag) runs one block an SM, where the float product's 8 x 8 patch
// fits its registers without spills and the SM's arithmetic is the bound.
// A segment's tasks are applied in their order by one block, so the result
// does not depend on the order blocks run in, and no atomics are used.
// The entry tables never change and are copied with cp.async.ca; the pool
// (written by earlier launches) only through L2, with cp.async.cg, and by
// 4- or 8-byte cp.async.ca where nb is not a multiple of a 16-byte word,
// which the launch boundary orders as well.  The float kernel sits at the
// 128-register cap of two blocks an SM: it holds no other body, and an edit
// here calls for `nvcc -Xptxas -v` (spills cost it 10-20 %).
#pragma once
#include "common.cuh"

namespace spllt {

constexpr int kNT = 256;        // threads, a 16 x 16 grid
constexpr int kKC = 16;         // contraction columns of one stage
constexpr int kStages = 3;      // stages in flight
constexpr int kEntBufs = 3;     // entry buffers: a unit's task, the next
                                // one's (in flight) and the one before
                                // (its sums may still be written out)

// the product's variant: IEEE arithmetic of T; one TF32 tensor-core pass
// (float only)
constexpr int kIeee = 0, kTf32 = 1;

template <typename T>
struct UpdCfg {
  static constexpr int TM = sizeof(T) == 4 ? 8 : 4;   // values a thread
  static constexpr int BM = 16 * TM;                  // rows of a sub-tile
  static constexpr int V = 16 / (int)sizeof(T);       // elements of 16 bytes
  static constexpr int LD = kKC + V;                  // stage row stride
  static constexpr int kItems = 2 * BM * (kKC / V) / kNT;   // words a thread
};

template <typename T>
__host__ __device__ constexpr size_t stage_elems() {
  return (size_t)UpdCfg<T>::BM * UpdCfg<T>::LD;
}

// dynamic shared memory: kStages stages of A and of B, then kEntBufs entry
// buffers of 2 nb ints
template <typename T>
size_t update_smem(int nb) {
  return 2 * kStages * stage_elems<T>() * sizeof(T) +
         kEntBufs * 2 * (size_t)nb * 4;
}

__device__ __forceinline__ void cp16z(void* s, const void* g, int bytes) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(g), "r"(bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cpz(void* s, const void* g, int bytes) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(sa),
               "l"(g), "n"(N), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as the float bit pattern with the low 13 bits clear
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// d += a b, one m16n8k8 TF32 product of a warp (float sums)
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2,
                                         float& d3, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// What every unit of a block reads.  A unit is the sub-tile (rs, cs) of
// task t: its compact rows [rs, rs + BM) and columns [cs, cs + BM).
template <typename T>
struct Ctx {
  T* pool;
  T* d;            // the segment's destination tile
  T* as;           // kStages stages of A, then of B
  T* bs;
  int* eb;         // kEntBufs entry buffers of 2 nb ints
  const int* eptr;
  const int* enr;
  const int* lor;
  const int* loc;
  const int* srcn;
  const int* ent;
  int nb, t1;
  bool vec;
};

struct Unit {
  int t, rs, cs;
  int g;           // ring stage of the unit's first chunk (mod kStages)
};

struct Shape {
  int nr, nc, m, n, kn;
  long long lr, lc;  // the task's windows
  bool chain;        // task t + 1 has the same live rows and columns
};

template <typename T>
__device__ __forceinline__ const int* entries(const Ctx<T>& c, int t) {
  return c.eb + (t % kEntBufs) * 2 * c.nb;
}

template <typename T>
__device__ __forceinline__ Shape shape(const Ctx<T>& c, Unit u) {
  constexpr int BM = UpdCfg<T>::BM;
  Shape s;
  const int e = c.enr[u.t];
  s.nr = e & 0xffff;
  s.chain = (e >> 16) & 1;
  s.nc = c.eptr[u.t + 1] - c.eptr[u.t] - s.nr;
  s.m = min(BM, s.nr - u.rs);
  s.n = min(BM, s.nc - u.cs);
  s.kn = min(c.srcn[u.t], c.nb);
  s.lr = c.lor[u.t];
  s.lc = c.loc[u.t];
  return s;
}

// stages of a unit: none without a live row or column
__device__ __forceinline__ int chunks(const Shape& s) {
  return s.m > 0 && s.n > 0 ? (s.kn + kKC - 1) / kKC : 0;
}

template <typename T>
__device__ __forceinline__ Unit next_unit(const Shape& s, Unit u) {
  constexpr int BM = UpdCfg<T>::BM;
  const int g = u.g + chunks(s);
  if (u.cs + BM < s.nc) return Unit{u.t, u.rs, u.cs + BM, g};
  if (u.rs + BM < s.nr) return Unit{u.t, u.rs + BM, 0, g};
  return Unit{u.t + 1, 0, 0, g};
}

// Chunk j of unit u: contraction columns [j kKC, (j + 1) kKC) of its
// compact rows (A) and columns (B), zero-filled from kn on, into ring
// stage (u.g + j) mod kStages.  Each thread copies kItems 16-byte words (a
// word's place in the stage is fixed by the thread, so the index math is
// shifts and masks).
template <typename T>
__device__ __forceinline__ void stage(const Ctx<T>& c, Unit u, const Shape& s,
                                      int j, int tid) {
  using C = UpdCfg<T>;
  constexpr int V = C::V, WPS = kKC / C::V;
  const int* e = entries(c, u.t);
  const size_t off = ((u.g + j) % kStages) * stage_elems<T>();
#pragma unroll
  for (int q = 0; q < C::kItems; ++q) {
    const int item = tid + kNT * q, row = item / WPS, w = item % WPS;
    if (row < s.m + s.n) {
      const bool isa = row < s.m;
      const int r = isa ? row : row - s.m;
      const int ent = isa ? e[u.rs + r] : e[s.nr + u.cs + r];
      const long long src = (isa ? s.lr : s.lc) + (ent & 0xffff);
      const int k = j * kKC + w * V;
      const int valid = max(0, min(V, s.kn - k));
      const T* g = c.pool + (size_t)src * c.nb + (valid > 0 ? k : 0);
      T* sd = (isa ? c.as : c.bs) + off + r * C::LD + w * V;
      if (c.vec) {
        cp16z(sd, g, valid * (int)sizeof(T));
      } else {
#pragma unroll
        for (int x = 0; x < V; ++x)
          cpz<sizeof(T)>(sd + x, x < valid ? g + x : g,
                         x < valid ? (int)sizeof(T) : 0);
      }
    }
  }
}

// Issue unit u's first kStages - 1 chunks, one group each, and before them,
// when u starts its task, the next task's entries (the caller made u's own
// entries visible).
template <typename T>
__device__ __forceinline__ void prologue(const Ctx<T>& c, Unit u,
                                         const Shape& s, int tid) {
  if (u.rs == 0 && u.cs == 0 && u.t + 1 < c.t1) {
    int* en = c.eb + ((u.t + 1) % kEntBufs) * 2 * c.nb;
    for (int q = c.eptr[u.t + 1] + tid; q < c.eptr[u.t + 2]; q += kNT)
      cpz<4>(en + q - c.eptr[u.t + 1], c.ent + q, 4);
  }
  cp_commit();
  const int nch = chunks(s);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nch) stage(c, u, s, j, tid);
    cp_commit();
  }
}

// The B fragments of column tile v (16 compact columns: two 16 x 8 mma
// tiles j) at contraction columns k0 + t and k0 + t + 4 of a stage, rounded
// to TF32.
__device__ __forceinline__ void tc_load_b(const float* bs, int v, int k0,
                                          int g, int t,
                                          unsigned (&bh)[2][2]) {
  constexpr int LD = UpdCfg<float>::LD;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* b = bs + (16 * v + 8 * j + g) * LD + k0 + t;
    bh[j][0] = tf32_rna(b[0]);
    bh[j][1] = tf32_rna(b[4]);
  }
}

// One stage of the tensor-core product: steps of 8 contraction columns.
// Warp w owns the unit's 16 x 16 tiles w + 8 q (q < NV), tile (i, v) =
// (tile / NV, tile % NV) of its rows and columns, live when i < nu; its
// sums are acc[4 j + r][q] (r the accumulator fragment's register of mma
// tile j).  Where NV divides 8 a warp's tiles share one column tile, and
// its B fragments are loaded once a step.
template <int NV, bool FULL>
__device__ __forceinline__ void tc_chunk(float (&acc)[8][NV],
                                         const float* as, const float* bs,
                                         int steps, int nu, int tid) {
  constexpr int LD = UpdCfg<float>::LD;
  constexpr bool kFixedV = 8 % NV == 0;
  const int w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  for (int st = 0; st < steps; ++st) {
    const int k0 = 8 * st;
    unsigned bh[2][2];
    if constexpr (kFixedV) tc_load_b(bs, w % NV, k0, g, t, bh);
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int tile = w + 8 * q;
      if (FULL || tile < nu * NV) {
        if constexpr (!kFixedV) tc_load_b(bs, tile % NV, k0, g, t, bh);
        const float* a = as + (16 * (tile / NV) + g) * LD + k0 + t;
        const unsigned ah[4] = {tf32_rna(a[0]), tf32_rna(a[8 * LD]),
                                tf32_rna(a[4]), tf32_rna(a[8 * LD + 4])};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // the step's products from a zero accumulator, then added to the
          // sums in float: the tensor core truncates what it adds, and
          // summed over a chain of many steps that bias would grow with
          // the number of steps
          float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
          mma_tf32(p0, p1, p2, p3, ah, bh[j]);
          acc[4 * j][q] += p0;
          acc[4 * j + 1][q] += p1;
          acc[4 * j + 2][q] += p2;
          acc[4 * j + 3][q] += p3;
        }
      }
    }
  }
}

// The tensor-core sums subtracted from the live destination cells of unit
// u (read all, then write all): the thread's rows g, g + 8 and columns
// 2 t, 2 t + 1 of each mma tile of its live tiles.
template <int NV, bool FULL>
__device__ __forceinline__ void tc_cells(float (&acc)[8][NV],
                                         const Ctx<float>& c, Unit u,
                                         const Shape& s, int nu, int tid) {
  const int w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  const int* e = entries(c, u.t);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int tile = w + 8 * q;
      if (FULL || tile < nu * NV) {
        const int i = tile / NV, v = tile % NV;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * i + g + 8 * h;
          if (r < s.m) {
            float* dr = c.d + (size_t)(e[u.rs + r] >> 16) * c.nb;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const int cc = 16 * v + 8 * j + 2 * t + x;
                if (cc < s.n) {
                  float& a = acc[4 * j + 2 * h + x][q];
                  const int col = e[s.nr + u.cs + cc] >> 16;
                  if (pass == 0)
                    a = dr[col] - a;
                  else
                    dr[col] = a;
                }
              }
          }
        }
      }
    }
  }
}

// Units from u on, as long as each task's live rows and columns are the
// next one's (a chain: the sums stay in registers), n <= 16 * NV (and all
// TM row groups live when FULL).  u's chunks were issued by prologue; the
// next unit's are issued during u's last chunk, so that the pipeline runs
// on from unit to unit, and a chain's sums are subtracted from the live
// destination cells while those loads are in flight.  Returns the next
// unit (its chunks issued).  P: the product's variant (see the top).
template <typename T, int NV, bool FULL, int P>
__device__ __noinline__ Unit run_units(Ctx<T> c, Unit u, int tid) {
  using C = UpdCfg<T>;
  constexpr int TM = C::TM, LD = C::LD;
  constexpr size_t SE = stage_elems<T>();
  static_assert(P == kIeee || sizeof(T) == 4, "TF32 takes float pools");
  const int tx = tid & 15, ty = tid >> 4;

  T acc[TM][NV];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[i][v] = T(0);
  bool any = false;     // a chunk was multiplied into acc

  for (;;) {
    const Shape s = shape(c, u);
    const int nch = chunks(s);
    const int nu = FULL ? TM : (s.m + 15) / 16;
    const Unit nx = next_unit<T>(s, u);
    const bool more = nx.t < c.t1;
    for (int ch = 0; ch < nch; ++ch) {
      cp_wait<kStages - 2>();
      __syncthreads();
      if (ch + kStages - 1 < nch) {
        stage(c, u, s, ch + kStages - 1, tid);
        cp_commit();
      } else if (ch == nch - 1 && more) {
        prologue(c, nx, shape(c, nx), tid);   // after this barrier, its
                                              // entries and stages are free
                                              // and visible
      } else {
        cp_commit();
      }
      const size_t off = ((u.g + ch) % kStages) * SE;
      if constexpr (P == kIeee) {
        const T* a0 = c.as + off + ty * LD;
        const T* b0 = c.bs + off + tx * LD;
        const int steps = (min(kKC, s.kn - ch * kKC) + 3) / 4;
        for (int st = 0; st < steps; ++st) {
          Vec4<T> b[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v)
            b[v] = *reinterpret_cast<const Vec4<T>*>(b0 + 16 * v * LD +
                                                     4 * st);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            if (FULL || i < nu) {
              const Vec4<T> a =
                  *reinterpret_cast<const Vec4<T>*>(a0 + 16 * i * LD +
                                                    4 * st);
#pragma unroll
              for (int v = 0; v < NV; ++v)
#pragma unroll
                for (int x = 0; x < 4; ++x) acc[i][v] += a.v[x] * b[v].v[x];
            }
          }
        }
      } else {
        tc_chunk<NV, FULL>(acc, c.as + off, c.bs + off,
                           (min(kKC, s.kn - ch * kKC) + 7) / 8, nu, tid);
      }
    }
    any |= nch > 0;
    if (nch == 0) {
      // nothing in flight for the next unit yet: its entries must land
      cp_wait<0>();
      __syncthreads();
      if (more) prologue(c, nx, shape(c, nx), tid);
    }
    if (s.chain && more && s.nr <= C::BM && s.nc <= C::BM) {
      u = nx;
      continue;
    }
    if constexpr (P != kIeee) {
      if (any) tc_cells<NV, FULL>(acc, c, u, s, nu, tid);
    } else if (any) {
      // the live cells: read all, then write all
      const int* e = entries(c, u.t);
      int col[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        col[v] = tx + 16 * v < s.n ? e[s.nr + u.cs + tx + 16 * v] >> 16 : -1;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + 16 * i;
        if (i < nu && r < s.m) {
          const T* dr = c.d + (size_t)(e[u.rs + r] >> 16) * c.nb;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (col[v] >= 0) acc[i][v] = dr[col[v]] - acc[i][v];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + 16 * i;
        if (i < nu && r < s.m) {
          T* dr = c.d + (size_t)(e[u.rs + r] >> 16) * c.nb;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (col[v] >= 0) dr[col[v]] = acc[i][v];
        }
      }
    }
    return nx;
  }
}

template <typename T, int NV, int P>
__device__ __forceinline__ Unit run_nv(int nv, int nu, const Ctx<T>& c,
                                       Unit u, int tid) {
  if constexpr (NV == UpdCfg<T>::TM) {
    if (nv == NV && nu == UpdCfg<T>::TM)
      return run_units<T, NV, true, P>(c, u, tid);
  }
  if constexpr (NV > 1) {
    if (nv < NV) return run_nv<T, NV - 1, P>(nv, nu, c, u, tid);
  }
  return run_units<T, NV, false, P>(c, u, tid);
}

// MINB blocks an SM: 2 in general (one block's latency hidden by the
// other's work), 1 for a level of long chains of near-dense tasks, where
// the float product's 8 x 8 patch then runs in registers without spills.
template <typename T, int MINB, int P = kIeee>
__global__ void __launch_bounds__(kNT, MINB)
    update_kernel(T* pool, const int* __restrict__ seg_ptr,
                  const int* __restrict__ dst, const int* __restrict__ lor,
                  const int* __restrict__ loc, const int* __restrict__ srcn,
                  const int* __restrict__ eptr, const int* __restrict__ enr,
                  const int* __restrict__ ent, int nb, int drows) {
  using C = UpdCfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int t0 = seg_ptr[blockIdx.x], t1 = seg_ptr[blockIdx.x + 1];
  if (t1 <= t0) return;
  Ctx<T> c;
  c.pool = pool;
  c.d = pool + (size_t)dst[t0] * drows * nb;
  c.as = reinterpret_cast<T*>(smem);
  c.bs = c.as + kStages * stage_elems<T>();
  c.eb = reinterpret_cast<int*>(c.bs + kStages * stage_elems<T>());
  c.eptr = eptr;
  c.enr = enr;
  c.lor = lor;
  c.loc = loc;
  c.srcn = srcn;
  c.ent = ent;
  c.nb = nb;
  c.t1 = t1;
  c.vec = nb % C::V == 0 && reinterpret_cast<size_t>(pool) % 16 == 0;

  // the first task's entries, then its first unit's stages
  int* e0 = c.eb + (t0 % kEntBufs) * 2 * nb;
  for (int q = eptr[t0] + tid; q < eptr[t0 + 1]; q += kNT)
    cpz<4>(e0 + q - eptr[t0], ent + q, 4);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  Unit u{t0, 0, 0, 0};
  prologue(c, u, shape(c, u), tid);
  while (u.t < t1) {
    const Shape s = shape(c, u);
    u = run_nv<T, C::TM, P>((s.n + 15) / 16, (s.m + 15) / 16, c, u, tid);
  }
}

template <typename T, int MINB, int P>
int update_launch_as(void* pool, const int* seg_ptr, const int* dst,
                     const int* lor, const int* loc, const int* srcn,
                     const int* eptr, const int* enr, const int* ent,
                     int nseg, int nb, int drows, size_t smem,
                     void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      update_kernel<T, MINB, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  update_kernel<T, MINB, P><<<nseg, kNT, smem, (cudaStream_t)stream>>>(
      (T*)pool, seg_ptr, dst, lor, loc, srcn, eptr, enr, ent, nb, drows);
  return (int)cudaGetLastError();
}

// One launch: one block per destination segment, segments seg_ptr[0 ..
// nseg] (task offsets into the tables), MINB 1 where the tables' dense flag
// is set, else 2.  The destination of task t starts at row dst[t] * drows of
// the pool: drows = nb where dst names a tile, 1 where it is a row base.
// P: the product's variant (kTf32 for float pools only).
template <typename T, int P = kIeee>
int update_launch(void* pool, const int* seg_ptr, const int* dst,
                  const int* lor, const int* loc, const int* srcn,
                  const int* eptr, const int* enr, const int* ent, int nseg,
                  int nb, int drows, int dense, void* stream) {
  if (nseg <= 0) return 0;
  const size_t smem = update_smem<T>(nb);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (dense)
    return update_launch_as<T, 1, P>(pool, seg_ptr, dst, lor, loc, srcn,
                                     eptr, enr, ent, nseg, nb, drows, smem,
                                     stream);
  return update_launch_as<T, 2, P>(pool, seg_ptr, dst, lor, loc, srcn, eptr,
                                   enr, ent, nseg, nb, drows, smem, stream);
}

}  // namespace spllt
