// The POTRF and TRSM work items of the factor stream kernel
// (mega_factor.cu), one thread block of kFacNT threads each.
//
// POTRF, one tile:  o = [[chol(D), 0], [B * chol(D)^-T, 0]]  over its first
// kv columns (D the lower triangle of the leading kv x kv block, B the rows
// >= kv of those columns), in place.  TRSM, rows [r0, r0 + nr) of one
// (diag, dst) pair:  dst <- dst * L^-T  with L the kv x kv lower triangle
// of the diag tile; columns >= kv become zero.
//
// Both are chains of dependent columns, short enough that an item's time
// is latency: the round trips to device memory, the block barriers and the
// dependent steps of the substitution.  So each item
//   - copies what it reads into shared memory at once: POTRF the lower
//     trapezoid of its first kv columns, TRSM its dst rows (16-byte
//     cp.async.cg where the rows line up) and L's lower triangle,
//     transposed, with the reciprocal of each pivot on its diagonal;
//   - eliminates in panels of P = 16 columns.  POTRF: warp 0 factors the
//     panel's P x P diagonal block in registers (lane = row, one rsqrt a
//     column), handing each finished column to the other lanes through
//     shared memory (one store, broadcast loads: no chain of shuffles);
//     then one thread a row below solves its P entries against the block
//     (the block's columns read as broadcasts, no barrier inside) and
//     writes them back and, column-major, into a panel buffer; then the
//     block applies the rank-P update to the trapezoid right of the panel
//     as a register-tiled product (4 x 4 values a thread, both operands
//     read k-major in 16-byte words).  Three block barriers a panel.
//     TRSM: the same row solve and product, with L^T in place of the
//     diagonal block and of the panel; two block barriers a panel.
// Every value is summed in a fixed order whatever the item's size and
// whichever block takes it, so results do not depend on the block count
// nor on how a TRSM run is cut into rows.  A non-positive (or NaN) pivot
// makes the whole POTRF tile NaN: the executor's guard reads element
// [0, 0] of every tile.
//
// The pool is written inside the launch, so it is read only through L2
// (cp.async.cg) or with ordinary loads, never through the read-only path.
// Where a tile does not fit in shared memory (nb = 256 in float32) POTRF
// works in place on the pool and TRSM stages L^T one panel at a time.
#pragma once
#include <type_traits>

#include "common.cuh"

namespace spllt {

constexpr int kFacNT = 256;
constexpr int kFacPanel = 16;       // columns of one elimination panel
constexpr int kFacTile = 64;        // rows and columns of a product tile
constexpr int kTrsmItemRows = 64;   // dst rows of a TRSM item, unsplit run

template <typename T>
struct FacVec {   // 16 bytes
  using type = typename std::conditional<sizeof(T) == 4, float4,
                                         double2>::type;
  static constexpr int V = 16 / (int)sizeof(T);
};

inline __host__ __device__ int fac_round4(int n) { return (n + 3) / 4 * 4; }
// whole panels
inline __host__ __device__ int fac_panels(int n) {
  return (n + kFacPanel - 1) / kFacPanel * kFacPanel;
}
// row stride of the transposed factor: past the last panel, and 4 mod 8
// words so that an 8 x 4 patch of it spans every bank
inline __host__ __device__ int fac_ldt(int nb) {
  return fac_panels(nb) + (fac_panels(nb) % 8 == 4 ? 8 : 4);
}

// Row stride of a tile read one row a thread: whole 16-byte words, an odd
// number of them (no two of eight neighbouring rows share a bank).
template <typename T>
inline __host__ __device__ int fac_ld(int nb) {
  constexpr int V = FacVec<T>::V;
  int ld = (nb + V - 1) / V * V;
  if ((ld / V) % 2 == 0) ld += V;
  return ld;
}

// Shared memory of a POTRF item: the failure flag (16 bytes), the
// diagonal block's L^T [P][P], the solved panel column-major [P][nb]
// and, in_smem, the tile [nb][fac_ld], else room for the product's reads
// past the panel's end.
template <typename T>
inline __host__ __device__ size_t fac_potrf_smem(int nb, bool in_smem) {
  return 16 + (size_t)kFacPanel * (kFacPanel + fac_round4(nb)) * sizeof(T) +
         (in_smem ? (size_t)nb * fac_ld<T>(nb) : kFacTile) * sizeof(T);
}

// Shared memory of a TRSM item staging `rows` dst rows: L^T [nb][nb]
// (l_in) or one panel of it [P][nb], the solved panel [P][rows], the
// rows [rows][fac_ld].
template <typename T>
inline __host__ __device__ size_t fac_trsm_smem(int nb, int rows,
                                                bool l_in) {
  return ((size_t)(l_in ? fac_panels(nb) : kFacPanel) * fac_ldt(nb) +
          (size_t)kFacPanel * fac_round4(rows) +
          (size_t)rows * fac_ld<T>(nb)) * sizeof(T);
}

__device__ __forceinline__ void fac_cp16(void* s, const void* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void fac_cp_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float fac_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double fac_rsqrt(double x) { return rsqrt(x); }
// correctly rounded reciprocals (as 1 / x), inline
__device__ __forceinline__ float fac_rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double fac_rcp(double x) { return __drcp_rn(x); }

template <typename T>
__device__ __forceinline__ Vec4<T> fac_load4(const T* p) {
  return *reinterpret_cast<const Vec4<T>*>(p);
}

// Rows [0, nr) of a row-major tile (stride nb) into shared memory (stride
// ld): row i's first min(i + 1, nc) columns when tri, else its first nc.
// In 16-byte words (cp.async.cg, rounded up to whole words) when vec, else
// with ordinary loads.  The caller waits (fac_cp_wait_all) and puts a
// block barrier before reading.
template <typename T>
__device__ __forceinline__ void fac_stage(T* d, int ld, const T* s, int nb,
                                          int nr, int nc, bool tri, bool vec,
                                          int tid) {
  constexpr int V = FacVec<T>::V;
  if (vec) {
    const int cpr = (nc + V - 1) / V;
    for (int e = tid; e < nr * cpr; e += kFacNT) {
      const int i = e / cpr, q = e - i * cpr;
      const int ncol = tri ? min(i + 1, nc) : nc;
      if (q * V < ncol)
        fac_cp16(d + i * ld + q * V, s + (size_t)i * nb + q * V);
    }
  } else {
    for (int e = tid; e < nr * nc; e += kFacNT) {
      const int i = e / nc, c = e - i * nc;
      if (!tri || c <= i) d[i * ld + c] = s[(size_t)i * nb + c];
    }
  }
}

// L^T of columns [j0, j0 + jn) of the lower triangle of l (stride nb,
// factor columns < kv) into lt (stride fac_ldt):
// lt[j - jb][c] = L[c][j] for j <= c < kv and lt[j - jb][j] = 1 / L[j][j];
// past kv, up to the end of the last panel, an identity (zero
// off the diagonal).  Ordinary loads (16 bytes where the rows line up),
// neighbouring threads on neighbouring rows c, four in flight a thread.
template <typename T>
__device__ __forceinline__ void fac_stage_lt(T* lt, int ldt, const T* l,
                                             int nb, int kv, int j0, int jn,
                                             int jb, bool vec, int tid) {
  constexpr int V = FacVec<T>::V, K = 4;
  using VT = typename FacVec<T>::type;
  const int w = vec ? V : 1;
  const int nq = (jn + w - 1) / w, nc = kv - j0;
  for (int base = tid; base < nq * nc; base += kFacNT * K) {
    T v[K][V];
    int cc[K], jq[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = base + k * kFacNT;
      const int q = nc > 0 ? e / nc : 0;
      cc[k] = j0 + (e - q * nc);
      jq[k] = j0 + q * w;
      if (e < nq * nc && cc[k] >= jq[k]) {
        if (vec) {
          const VT x =
              *reinterpret_cast<const VT*>(l + (size_t)cc[k] * nb + jq[k]);
#pragma unroll
          for (int u = 0; u < V; ++u)
            v[k][u] = reinterpret_cast<const T*>(&x)[u];
        } else {
          v[k][0] = l[(size_t)cc[k] * nb + jq[k]];
        }
      } else {
        cc[k] = -1;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int j = jq[k] + u, c = cc[k];
        if (c >= 0 && u < w && j <= c && j < j0 + jn)
          lt[(j - jb) * ldt + c] = j == c ? fac_rcp(v[k][u]) : v[k][u];
      }
    }
  }
  // the identity past kv: rows [j0, j0 + jnp) x columns [kv, kvp)
  const int np = fac_panels(kv) - kv, jnp = fac_panels(jn);
  for (int e = tid; e < jnp * np; e += kFacNT) {
    const int j = j0 + e / np, c = kv + e % np;
    lt[(j - jb) * ldt + c] = j == c ? T(1) : T(0);
  }
}

// lt holds L's lower triangle row-major (rows < kv); make it L^T in the
// upper triangle: lt[j][c] = L[c][j] for c > j, lt[j][j] = 1 / L[j][j],
// and an identity past kv up to the end of the last panel.  The lower
// cells are only read and the upper ones only written.  Each warp takes
// 8 x 4 patches (8 columns j by 4 rows c, every bank once), eight at a
// time.  No block barrier.
template <typename T>
__device__ __forceinline__ void fac_mirror(T* lt, int ldt, int kv, int tid) {
  constexpr int U = 8;      // patches a warp has in flight
  const int kvp = fac_panels(kv);
  const int nj = kvp / 8, nq = nj * (kvp / 4);
  const int lane = tid & 31, warp = tid >> 5;
  for (int q0 = warp * U; q0 < nq; q0 += kFacNT / 32 * U) {
    T v[U];
    int at[U];
    int pj = q0 % nj, pc = q0 / nj;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = pj * 8 + (lane & 7), c = pc * 4 + (lane >> 3);
      at[u] = q0 + u < nq && c >= j ? j * ldt + c : -1;
      // below kv the lower cell (the diagonal cell itself when c == j);
      // past kv the identity (the read is inside lt and unused)
      const T x = lt[c * ldt + j];
      const T d = c == j ? T(1) : T(0);
      v[u] = c >= kv ? d : c == j ? fac_rcp(x) : x;
      if (++pj == nj) {
        pj = 0;
        ++pc;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at[u] >= 0) lt[at[u]] = v[u];
  }
}

// POTRF: warp 0 factors the pb x pb diagonal block at (j0, j0) of w in
// registers, lane l holding row j0 + l (lanes >= pb an identity row, so
// every panel runs all P steps without a guard).  Each finished column j
// goes to ltd[j][:] (ltd[j][c] = L[c][j] below the diagonal, 1 / L[j][j]
// on it, zero above), from where every lane reads it back as broadcasts to
// update the columns right of it, all but the next one, which a shuffle
// hands over; the next pivot comes from its own lane's entries, so that
// the chain of pivots waits for neither; L goes back into w.  Lanes update the
// entries above their diagonal too (no branch) and zero them when the
// column is reached.  Returns whether a pivot was not positive (the same
// on every lane).
template <typename T, bool VEC>
__device__ __forceinline__ bool fac_diag_factor(T* w, int ld, int j0, int pb,
                                                T* ltd, int lane) {
  constexpr int V = FacVec<T>::V;
  using VT = typename FacVec<T>::type;
  constexpr int P = kFacPanel;
  T d[P];
#pragma unroll
  for (int j = 0; j < P; ++j) d[j] = T(0);
  T* row = w + (size_t)(j0 + lane) * ld + j0;
  if (lane < pb) {
    if (VEC) {
#pragma unroll
      for (int q = 0; q < P / V; ++q) {
        if (q * V < pb) {      // not past the row's end
          const VT x = *reinterpret_cast<const VT*>(row + q * V);
#pragma unroll
          for (int u = 0; u < V; ++u)
            d[q * V + u] = reinterpret_cast<const T*>(&x)[u];
        }
      }
    } else {
      for (int j = 0; j < pb; ++j) d[j] = row[j];
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j)
    d[j] = j > lane || j >= pb ? (lane >= pb && j == lane ? T(1) : T(0))
                               : d[j];
  bool bad = false;
  T pnext = __shfl_sync(kFull, d[0], 0);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const T piv = pnext;
    bad |= !(piv > T(0));               // catches <= 0 and NaN
    const T r = fac_rsqrt(piv);
    d[j] = lane == j ? piv * r : lane > j ? d[j] * r : T(0);
    if (lane < P) ltd[j * P + lane] = lane == j ? r : d[j];
    if (j + 1 < P) {
      // the next pivot, from lane j + 1's own entries (the same value the
      // column update below gives it), then that column by shuffle
      const T own = d[j + 1] - d[j] * d[j];
      pnext = __shfl_sync(kFull, own, j + 1);
      const T ln = __shfl_sync(kFull, d[j], j + 1);
      d[j + 1] -= d[j] * ln;
    }
    __syncwarp();
#pragma unroll
    for (int g = (j + 2) / 4; g < P / 4; ++g) {
      const Vec4<T> l4 = fac_load4(ltd + j * P + 4 * g);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * g + u > j + 1) d[4 * g + u] -= d[j] * l4.v[u];
    }
  }
  if (lane < pb) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < pb) row[j] = d[j];
  }
  return bad;
}

// Rows [row0, row1) of x (stride ldx), columns j0 .. j0 + pb - 1, solved
// against a panel's lower triangle given transposed: x_row <- x_row *
// L^-T with lt[j][c] = L[c][j] (stride ldt) for c > j and lt[j][j] =
// 1 / L[j][j]; for pb < P, lt is an identity beyond pb.  One thread a
// row, right-looking in registers (lt read as broadcasts, all P steps
// without a guard); each solved row goes back to x and to column r of the
// column-major panel pt (stride ldp).  No block barrier.
template <typename T, bool VX>
__device__ __forceinline__ void fac_rows(T* x, int ldx, int row0, int row1,
                                         int j0, int pb, const T* lt,
                                         int ldt, T* pt, int ldp, int tid) {
  constexpr int V = FacVec<T>::V;
  using VT = typename FacVec<T>::type;
  constexpr int P = kFacPanel;
  for (int r = row0 + tid; r < row1; r += kFacNT) {
    T* xr = x + (size_t)r * ldx + j0;
    T v[P];
    if (VX) {
#pragma unroll
      for (int q = 0; q < P / V; ++q) {
        if (q * V < pb) {      // not past the row's end
          const VT a = *reinterpret_cast<const VT*>(xr + q * V);
#pragma unroll
          for (int u = 0; u < V; ++u)
            v[q * V + u] = reinterpret_cast<const T*>(&a)[u];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) v[j] = j < pb ? xr[j] : T(0);
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j >= pb) v[j] = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      v[j] *= lt[j * ldt + j];
#pragma unroll
      for (int g = (j + 1) / 4; g < P / 4; ++g) {
        const Vec4<T> l4 = fac_load4(lt + j * ldt + 4 * g);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * g + u > j) v[4 * g + u] -= v[j] * l4.v[u];
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (j < pb) {
        xr[j] = v[j];
        pt[j * ldp + r] = v[j];
      }
    }
  }
}

// C[i][c] -= sum_{p < pb} at[p][i] * bt[p][c]  for i in [i0, i1), c in
// [c0, c1) (at, bt k-major, strides lda / ldb; i0, c0 multiples of 4).
// LOWER skips the tiles wholly above the diagonal (entries above it inside
// a tile are written too, and never read).  Tiles of TR x 4096 / TR (TR =
// 64, or 32 or 16 for a TRSM item of that few rows), thread (ty, tx)
// holding rows 4ty .. 4ty + 3 and columns 4tx .. 4tx + 3; operands are
// read past i1 / c1 to the tile's edge (the caller's buffers leave room)
// and those sums are dropped.  VC: C's rows take 4-wide vectors.  No block
// barrier.
template <typename T, bool VC, bool LOWER, int TR = kFacTile>
__device__ __forceinline__ void fac_product(T* C, int ldc, const T* at,
                                            int lda, const T* bt, int ldb,
                                            int pb, int i0, int i1, int c0,
                                            int c1, int tid) {
  constexpr int TC = 4 * kFacNT * 4 / TR;    // tile columns
  const int ty = tid / (TC / 4), tx = tid % (TC / 4);
  const int nti = (i1 - i0 + TR - 1) / TR;
  const int ntc = (c1 - c0 + TC - 1) / TC;
  for (int t = 0; t < nti * ntc; ++t) {
    const int ti = i0 + (t / ntc) * TR;
    const int tc = c0 + (t % ntc) * TC;
    if (LOWER && tc > ti + TR - 1) continue;
    const T* pa = at + ti + 4 * ty;
    const T* pb_ = bt + tc + 4 * tx;
    T acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = T(0);
    auto step = [&](int p) {
      const Vec4<T> a4 = fac_load4(pa + (size_t)p * lda);
      const Vec4<T> b4 = fac_load4(pb_ + (size_t)p * ldb);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += a4.v[a] * b4.v[b];
    };
    if (pb == kFacPanel) {
#pragma unroll
      for (int p = 0; p < kFacPanel; ++p) step(p);
    } else {
      for (int p = 0; p < pb; ++p) step(p);
    }
    const int cb = tc + 4 * tx;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + 4 * ty + a;
      if (i >= i1) continue;
      T* ci = C + (size_t)i * ldc + cb;
      if (VC && cb + 3 < c1) {
        Vec4<T> c4 = fac_load4(ci);
#pragma unroll
        for (int b = 0; b < 4; ++b) c4.v[b] -= acc[a][b];
        *reinterpret_cast<Vec4<T>*>(ci) = c4;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (cb + b < c1) ci[b] -= acc[a][b];
      }
    }
  }
}

// The block's dynamic shared memory (the item bodies use it from its
// start).  The stream kernel calls each item body out of line, so that
// each gets its own register allocation under the kernel's cap.
extern __shared__ __align__(16) unsigned char fac_smem[];

// POTRF of one tile in place, kv factor columns.  SMEM: the working tile
// in shared memory (else in place on the pool).  Ends with every thread's
// writes to the tile made; the caller puts a block barrier before the
// shared memory is used again.
template <typename T, bool SMEM>
__device__ __forceinline__ void fac_potrf_item(T* tile, int kv, int nb,
                                            int tid) {
  unsigned char* smem_raw = fac_smem;
  constexpr int V = FacVec<T>::V;
  using VT = typename FacVec<T>::type;
  int* sbad = reinterpret_cast<int*>(smem_raw);
  T* ltd = reinterpret_cast<T*>(smem_raw + 16);      // [P][P]
  T* pt = ltd + kFacPanel * kFacPanel;               // [P][ldp]
  const int ldp = fac_round4(nb);
  T* w = SMEM ? pt + kFacPanel * ldp : tile;
  const int ld = SMEM ? fac_ld<T>(nb) : nb;
  const bool gvec =
      nb % V == 0 && reinterpret_cast<size_t>(tile) % 16 == 0;
  const int lane = tid & 31;

  if (tid == 0) *sbad = 0;
  if (SMEM) {
    fac_stage(w, ld, tile, nb, nb, kv, true, gvec, tid);
    fac_cp_wait_all();
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
  if (SMEM && gvec) {
    const int cv = nb / V;
    for (int e = tid; e < nb * cv; e += kFacNT) {
      const int i = e / cv, c = (e - i * cv) * V;
      VT v;
      T* pv = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int u = 0; u < V; ++u)
        pv[u] = bad ? qnan
                    : (c + u < kv && c + u <= i) ? w[i * ld + c + u] : T(0);
      *reinterpret_cast<VT*>(tile + (size_t)i * nb + c) = v;
    }
  } else {
    for (int e = tid; e < nb * nb; e += kFacNT) {
      const int i = e / nb, c = e - i * nb;
      tile[e] = bad ? qnan : (c < kv && c <= i) ? w[i * ld + c] : T(0);
    }
  }
}

// TRSM of dst rows [r0, r0 + nr) of one (diag, dst) pair, kv factor
// columns, in place on dst; rows are staged `rows` at a time.  LSMEM: L^T
// kept whole in shared memory (else staged a panel at a time).  Ends with
// every thread's writes to dst made; the caller puts a block barrier
// before the shared memory is used again.
template <typename T, bool LSMEM>
__device__ __forceinline__ void fac_trsm_item(const T* l, T* dst, int kv,
                                           int nb, int r0, int nr, int rows,
                                           int tid) {
  unsigned char* smem_raw = fac_smem;
  constexpr int V = FacVec<T>::V;
  using VT = typename FacVec<T>::type;
  const int ldt = fac_ldt(nb), ldp = fac_round4(rows);
  const int ldx = fac_ld<T>(nb);
  T* lt = reinterpret_cast<T*>(smem_raw);      // [nb or P][ldt]
  T* pt = lt + (size_t)(LSMEM ? fac_panels(nb) : kFacPanel) * ldt;
  T* xr = pt + kFacPanel * ldp;                // [rows][ldx]
  const bool gvec = nb % V == 0 &&
                    reinterpret_cast<size_t>(l) % 16 == 0 &&
                    reinterpret_cast<size_t>(dst) % 16 == 0;

  // L row-major into lt's rows, then mirrored into its upper half
  if (LSMEM) fac_stage(lt, ldt, l, nb, kv, kv, true, gvec, tid);
  for (int s0 = r0; s0 < r0 + nr; s0 += rows) {
    const int m = min(rows, r0 + nr - s0);
    T* drow = dst + (size_t)s0 * nb;
    if (s0 > r0) __syncthreads();      // the previous rows are written out
    fac_stage(xr, ldx, drow, nb, m, kv, false, gvec, tid);
    fac_cp_wait_all();
    __syncthreads();
    if (LSMEM && s0 == r0) {
      fac_mirror(lt, ldt, kv, tid);
      __syncthreads();
    }
    for (int j0 = 0; j0 < kv; j0 += kFacPanel) {
      const int pb = min(kFacPanel, kv - j0);
      if (!LSMEM) {
        fac_stage_lt(lt, ldt, l, nb, kv, j0, pb, j0, gvec, tid);
        __syncthreads();
      }
      const T* lp = LSMEM ? lt + (size_t)j0 * ldt : lt;   // row p: L[:, j0+p]
      fac_rows<T, true>(xr, ldx, 0, m, j0, pb, lp + j0, ldt, pt, ldp, tid);
      __syncthreads();
      if (j0 + pb < kv) {
        if (m <= 16)
          fac_product<T, true, false, 16>(xr, ldx, pt, ldp, lp, ldt, pb, 0,
                                          m, j0 + pb, kv, tid);
        else if (m <= 32)
          fac_product<T, true, false, 32>(xr, ldx, pt, ldp, lp, ldt, pb, 0,
                                          m, j0 + pb, kv, tid);
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
        *reinterpret_cast<VT*>(drow + (size_t)i * nb + c) = v;
      }
    } else {
      for (int e = tid; e < m * nb; e += kFacNT) {
        const int i = e / nb, c = e - i * nb;
        drow[e] = c < kv ? xr[i * ldx + c] : T(0);
      }
    }
  }
}

}  // namespace spllt
