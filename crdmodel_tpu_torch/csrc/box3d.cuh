// The 3-D box's operator and the grid-wide scheme of the port's box kernels
// (K6 fused_box3d.cu, K7 fused_box3d_rkc.cu, and on one shard of a mesh K12
// fused_shard_box3d.cu, K13 fused_shard_box3d_rkc.cu).
//
// The state is (2, nz, ny, nx), contiguous. z is clamped: the planes above
// the top and below the bottom read the top and bottom planes, which is
// exact because the kernels take only closed z walls (ops/kernel_common.py::
// box_mode), where the coefficients across the z seam are zero. How x and y
// find their neighbours is a grid policy, a template parameter of the
// operator: BoxWrap (K6) wraps them periodically on the whole box;
// BoxHalo (K12) reads them from a shard's halo-padded buffer, (nz,
// nyl + 2 halo, nxl + 2 halo), whose halo the mesh's exchange filled, and
// wraps nothing (box_stream.cuh's StreamWrap and StreamHalo are the same
// policies for the streaming passes of K6, K7, K12 and K13, on which the
// shard kernels index the buffer alike). A shard kernel indexes every
// constant by the buffer's
// (k, j, i): its profiles, rows and fields are halo-padded the same way.
// The operator on variable 0 comes in four modes (BoxMode), a template
// parameter of each kernel, as the kinetics family is:
//   profile  aE, aW (nx,), aN, aS (ny,), aU, aD (nz,): constant D with walls
//   tissue   the profiles, each face times t * t_neighbour of the (nz, ny,
//            nx) 0/1 tissue field (exact), and ydot times t
//   field    aE, aN, aU as (nz, ny, nx) fields; aW is aE at i-1, aS is aN at
//            j-1 (the grid policy's neighbour), aD is aU at k-1 and 0 at
//            k = 0
//   tensor   field's faces plus Dxy, Dxz, Dyz (nz, ny, nx) and the weights
//            invs = (1/(4 dx dy), 1/(4 dx dz), 1/(4 dy dz)): 19 points
// The expressions follow the plain version (ops/kernel_common.py::
// box_kernel_laplacian, make_box_rhs_block) operation for operation, and
// the library is built with -fmad=false, so each operation rounds as
// PyTorch's does. A structured forcing (rhs_common.cuh::BoxStimTable)
// adds its terms at the point's plane, row and column before the freeze
// and the tissue field (box_rhs_at); NoStim compiles it out.
//
// The persistent scheme here is K6's and K12's for the tableaus other than
// bs32 (zonneveld43, dopri54); their bs32 steps and every step of K7 and
// K13 run box_stream.cuh's z-streaming passes (box_rkc_stream.cuh for
// RKC2): one cooperative launch of as many blocks as the card keeps
// resident, each thread walking the points with a grid stride, and a
// grid-wide barrier between stages, whose values live in a scratch buffer
// in device memory (the wrapper's `work`). Coefficient and tissue fields
// are read through the read-only data cache; the stage values, written by
// the same launch, with plain loads.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "rhs_common.cuh"

namespace crd {

namespace cg = cooperative_groups;

constexpr int kBoxThreads = 256;   // ops/fused_box3d.py THREADS

enum BoxMode { kBoxProfile = 0, kBoxTissue = 1, kBoxField = 2, kBoxTensor = 3 };

// The operator's inputs (see the modes above; unused pointers are null),
// and beta, the interior-row mask and the freeze flag in k (its profile
// pointers unused).
template <typename T>
struct BoxConstants {
  const T* c[6];
  const T* tissue;   // (nz, ny, nx) 0/1, or null
  const T* invs;     // (3,), tensor mode only
  RhsConstants<T> k;
  int nz;
  int ny;
  int nx;

  __device__ __forceinline__ size_t at(int kk, int jj, int ii) const {
    return (static_cast<size_t>(kk) * ny + jj) * nx + ii;
  }
};

// The grid policies: next(i, n) and prev(i, n), the neighbours of index i
// along an in-plane axis of extent n (x with nx, y with ny).
//
// BoxWrap: the whole periodic box of K6.
struct BoxWrap {
  __device__ static __forceinline__ int next(int i, int n) {
    return i == n - 1 ? 0 : i + 1;
  }
  __device__ static __forceinline__ int prev(int i, int n) {
    return i == 0 ? n - 1 : i - 1;
  }
};

// BoxHalo: one shard's halo-padded buffer (K12). The kernels evaluate
// points at most halo - 1 rings outside the block, so every neighbour lies
// in the buffer; the clamp at its edge only keeps a stray index inside it.
struct BoxHalo {
  __device__ static __forceinline__ int next(int i, int n) {
    return min(i + 1, n - 1);
  }
  __device__ static __forceinline__ int prev(int i, int n) {
    return max(i - 1, 0);
  }
};

// The operator at point (k, j, i), flat index g, of variable 0 held in su.
template <int Mode, class Grid, typename T>
__device__ __forceinline__ T box_lap(const BoxConstants<T>& c, const T* su,
                                     int k, int j, int i, size_t g) {
  const int iE = Grid::next(i, c.nx);
  const int iW = Grid::prev(i, c.nx);
  const int jN = Grid::next(j, c.ny);
  const int jS = Grid::prev(j, c.ny);
  const int kU = k == c.nz - 1 ? k : k + 1;
  const int kD = k == 0 ? 0 : k - 1;
  const T u = su[g];
  const T uE = su[c.at(k, j, iE)], uW = su[c.at(k, j, iW)];
  const T uN = su[c.at(k, jN, i)], uS = su[c.at(k, jS, i)];
  const T uU = su[c.at(kU, j, i)], uD = su[c.at(kD, j, i)];
  T aE, aW, aN, aS, aU, aD;
  if (Mode == kBoxProfile || Mode == kBoxTissue) {
    aE = __ldg(c.c[0] + i);
    aW = __ldg(c.c[1] + i);
    aN = __ldg(c.c[2] + j);
    aS = __ldg(c.c[3] + j);
    aU = __ldg(c.c[4] + k);
    aD = __ldg(c.c[5] + k);
    if (Mode == kBoxTissue) {
      const T t = __ldg(c.tissue + g);
      aE = aE * (t * __ldg(c.tissue + c.at(k, j, iE)));
      aW = aW * (t * __ldg(c.tissue + c.at(k, j, iW)));
      aN = aN * (t * __ldg(c.tissue + c.at(k, jN, i)));
      aS = aS * (t * __ldg(c.tissue + c.at(k, jS, i)));
      aU = aU * (t * __ldg(c.tissue + c.at(kU, j, i)));
      aD = aD * (t * __ldg(c.tissue + c.at(kD, j, i)));
    }
  } else {
    aE = __ldg(c.c[0] + g);
    aW = __ldg(c.c[0] + c.at(k, j, iW));
    aN = __ldg(c.c[1] + g);
    aS = __ldg(c.c[1] + c.at(k, jS, i));
    aU = __ldg(c.c[2] + g);
    aD = k == 0 ? T(0) : __ldg(c.c[2] + c.at(k - 1, j, i));
  }
  T lap = aE * (uE - u) + aW * (uW - u) + aN * (uN - u) + aS * (uS - u)
          + aU * (uU - u) + aD * (uD - u);
  if (Mode == kBoxTensor) {
    const T* dxy = c.c[3];
    const T* dxz = c.c[4];
    const T* dyz = c.c[5];
    // xy: fluxes Dxy (uN - uS) at i +- 1 and Dxy (uE - uW) at j +- 1
    const T uNE = su[c.at(k, jN, iE)], uSE = su[c.at(k, jS, iE)];
    const T uNW = su[c.at(k, jN, iW)], uSW = su[c.at(k, jS, iW)];
    const T t_xy = (__ldg(dxy + c.at(k, j, iE)) * (uNE - uSE)
                    - __ldg(dxy + c.at(k, j, iW)) * (uNW - uSW))
                   + (__ldg(dxy + c.at(k, jN, i)) * (uNE - uNW)
                      - __ldg(dxy + c.at(k, jS, i)) * (uSE - uSW));
    // xz: Dxz (uU - uD) at i +- 1 and Dxz (uE - uW) on the planes k +- 1
    const T uUE = su[c.at(kU, j, iE)], uDE = su[c.at(kD, j, iE)];
    const T uUW = su[c.at(kU, j, iW)], uDW = su[c.at(kD, j, iW)];
    const T t_xz = (__ldg(dxz + c.at(k, j, iE)) * (uUE - uDE)
                    - __ldg(dxz + c.at(k, j, iW)) * (uUW - uDW))
                   + (__ldg(dxz + c.at(kU, j, i)) * (uUE - uUW)
                      - __ldg(dxz + c.at(kD, j, i)) * (uDE - uDW));
    // yz: Dyz (uU - uD) at j +- 1 and Dyz (uN - uS) on the planes k +- 1
    const T uUN = su[c.at(kU, jN, i)], uDN = su[c.at(kD, jN, i)];
    const T uUS = su[c.at(kU, jS, i)], uDS = su[c.at(kD, jS, i)];
    const T t_yz = (__ldg(dyz + c.at(k, jN, i)) * (uUN - uDN)
                    - __ldg(dyz + c.at(k, jS, i)) * (uUS - uDS))
                   + (__ldg(dyz + c.at(kU, j, i)) * (uUN - uUS)
                      - __ldg(dyz + c.at(kD, j, i)) * (uDN - uDS));
    lap = ((lap + __ldg(c.invs) * t_xy) + __ldg(c.invs + 1) * t_xz)
          + __ldg(c.invs + 2) * t_yz;
  }
  return lap;
}

// ydot = f(u, v) at point (k, j, i), flat index g: the kinetics plus the
// operator on variable 0, plus a structured forcing's terms at amplitude
// column a (stim a BoxStimTable; NoStim compiles them out), times live with
// a freeze, times the tissue field with an obstacle.
template <int Mode, int Kin, class Grid, typename T, class Stim>
__device__ __forceinline__ void box_rhs_at(const BoxConstants<T>& c, T fz,
                                           const Stim& stim, int a,
                                           const T* su, const T* sv, int k,
                                           int j, int i, size_t g,
                                           T& du_out, T& dv_out) {
  const T lap = box_lap<Mode, Grid>(c, su, k, j, i, g);
  T du, dv, fu = T(0), fv = T(0);
  kinetics<Kin>(su[g], sv[g], beta_at(c.k, j), du, dv);
  if constexpr (Stim::kOn) stim.at(a, k, j, i, fu, fv);
  add_operator<Stim::kOn>(lap, fu, fv, du, dv);
  if (c.k.has_freeze) {
    const T live = live_at(c.k, fz, j);
    du = du * live;
    dv = dv * live;
  }
  if (c.tissue != nullptr) {
    const T tis = __ldg(c.tissue + g);
    du = du * tis;
    dv = dv * tis;
  }
  du_out = du;
  dv_out = dv;
}

// box_rhs_at on the whole periodic box (K6, K7) at flat index g.
template <int Mode, int Kin, typename T, class Stim>
__device__ __forceinline__ void box_rhs(const BoxConstants<T>& c, T fz,
                                        const Stim& stim, int a,
                                        const T* su, const T* sv, size_t g,
                                        T& du_out, T& dv_out) {
  const int i = static_cast<int>(g % c.nx);
  const size_t row = g / c.nx;
  const int j = static_cast<int>(row % c.ny);
  const int k = static_cast<int>(row / c.ny);
  box_rhs_at<Mode, Kin, BoxWrap>(c, fz, stim, a, su, sv, k, j, i, g, du_out,
                                 dv_out);
}

// The amplitude column of an RKC2 step's evaluation e in the box kernels'
// forcing table (rhs_common.cuh::rkc_amp_column); 0 without a forcing.
template <class Stim>
__device__ __forceinline__ int box_rkc_column(const Stim& stim, int e) {
  if constexpr (Stim::kOn)
    return rkc_amp_column(e, stim.s.n_cols);
  else
    return 0;
}

// One shard's block inside its halo-padded buffer (K12, K13): the buffer is
// (nz, nyl + 2 halo, nxl + 2 halo), the block at [halo, halo + nyl) x
// [halo, halo + nxl) of every plane; on a padded mesh only its first
// valid_rows x valid_cols cells are physical, the others mirror-pad cells
// that step like their sources and stay out of the error sum.
struct BoxShard {
  int halo;
  int nyl;
  int nxl;
  int valid_rows;
  int valid_cols;

  __device__ __forceinline__ bool counted(int j, int i) const {
    return j - halo < valid_rows && i - halo < valid_cols;
  }
};

// The block and the r rings around it, every plane: size() points, the
// q-th at (k, j, i) of the buffer, plane by plane and row by row.
struct BoxRing {
  int nz;
  int rows;
  int cols;
  int first;     // the first row and column: halo - r

  __device__ __forceinline__ BoxRing(const BoxShard& s, int nz_, int r)
      : nz(nz_), rows(s.nyl + 2 * r), cols(s.nxl + 2 * r),
        first(s.halo - r) {}
  __device__ __forceinline__ size_t size() const {
    return static_cast<size_t>(nz) * rows * cols;
  }
  __device__ __forceinline__ void point(size_t q, int& k, int& j,
                                        int& i) const {
    i = first + static_cast<int>(q % cols);
    const size_t row = q / cols;
    j = first + static_cast<int>(row % rows);
    k = static_cast<int>(row / rows);
  }
};

// The BoxShard of a shard launcher's arguments, whose buffer is (nz, ny,
// nx); false unless it holds a block at least `halo` deep, `depth` <=
// halo rings the kernel reads, and a physical extent inside the block.
inline bool make_box_shard(int ny, int nx, int halo, int depth,
                           int valid_rows, int valid_cols, BoxShard* out) {
  const int nyl = ny - 2 * halo, nxl = nx - 2 * halo;
  if (depth < 1 || halo < depth || nyl < halo || nxl < halo
      || valid_rows < 0 || valid_rows > nyl || valid_cols < 0
      || valid_cols > nxl)
    return false;
  *out = BoxShard{halo, nyl, nxl, valid_rows, valid_cols};
  return true;
}

// The constants of the launchers' common arguments; false when they are
// out of range.
template <typename T>
bool make_box_constants(const void* const c[6], const void* tissue,
                        const void* invs, int mode, const void* beta,
                        int beta_field, const void* mask, int has_freeze,
                        int nz, int ny, int nx, BoxConstants<T>* out) {
  if (nz < 1 || ny < 1 || nx < 1 || mode < kBoxProfile || mode > kBoxTensor)
    return false;
  const int n_coeffs = mode == kBoxField ? 3 : 6;
  for (int q = 0; q < n_coeffs; ++q)
    if (c[q] == nullptr) return false;
  if ((mode == kBoxTissue && tissue == nullptr)
      || (mode == kBoxTensor && invs == nullptr))
    return false;
  *out = BoxConstants<T>{};
  for (int q = 0; q < 6; ++q) out->c[q] = static_cast<const T*>(c[q]);
  out->tissue = static_cast<const T*>(tissue);
  out->invs = static_cast<const T*>(invs);
  out->k = {nullptr, nullptr, nullptr, 0, static_cast<const T*>(beta),
            beta_field, static_cast<const T*>(mask), has_freeze};
  out->nz = nz;
  out->ny = ny;
  out->nx = nx;
  return true;
}

// f(integral_constant<Mode>, integral_constant<Kinetics>) for the runtime
// mode and kinetics ids: the kernel instantiation to launch.
template <int Mode, class F>
int dispatch_kinetics(int kinetics, F& f) {
  using std::integral_constant;
  if (kinetics == kFhn)
    return f(integral_constant<int, Mode>{}, integral_constant<int, kFhn>{});
  if (kinetics == kGoldbeter)
    return f(integral_constant<int, Mode>{},
             integral_constant<int, kGoldbeter>{});
  return f(integral_constant<int, Mode>{},
           integral_constant<int, kAlievPanfilov>{});
}

template <class F>
int dispatch_box(int mode, int kinetics, F f) {
  if (!valid_kinetics(kinetics)) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kBoxProfile: return dispatch_kinetics<kBoxProfile>(kinetics, f);
    case kBoxTissue: return dispatch_kinetics<kBoxTissue>(kinetics, f);
    case kBoxField: return dispatch_kinetics<kBoxField>(kinetics, f);
    case kBoxTensor: return dispatch_kinetics<kBoxTensor>(kinetics, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A cooperative launch of `kernel` over n_points points: as many blocks as
// stay resident on the card (every block must reach each grid barrier), at
// most one a `threads` points and at most `capacity` (the partial sums'
// length), each of `threads` threads with `smem` bytes of dynamic shared
// memory. The grid size goes to *n_blocks; returns the CUDA error code.
template <typename Kernel>
int launch_cooperative(Kernel kernel, size_t n_points, int capacity,
                       int* n_blocks, void** args, void* stream,
                       size_t smem = 0, int threads = kBoxThreads) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t want = (n_points + threads - 1) / threads;
  size_t blocks = static_cast<size_t>(sms) * per_sm;
  if (want < blocks) blocks = want;
  if (static_cast<size_t>(capacity) < blocks) blocks = capacity;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *n_blocks = static_cast<int>(blocks);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(blocks)),
                                    dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace crd

// The operator arguments every box launcher takes after its own: c0..c5
// (null past the mode's count), the tissue field, the tensor weights, the
// mode, beta, the mask, the freeze flag, the kinetics id and the shape.
#define CRD_BOX_OPERATOR_ARGS                                                \
  const void *c0, const void *c1, const void *c2, const void *c3,           \
      const void *c4, const void *c5, const void *tissue, const void *invs, \
      int mode, const void *beta, int beta_field, const void *mask,         \
      int has_freeze, int kinetics, int nz, int ny, int nx, double rtol,    \
      double atol, void *stream
#define CRD_BOX_OPERATOR_PASS                                                \
  c0, c1, c2, c3, c4, c5, tissue, invs, mode, beta, beta_field, mask,       \
      has_freeze, kinetics, nz, ny, nx, rtol, atol, stream

// A box launcher's structured forcing, its last arguments: the amplitude
// table, the row and column profiles and the depth table, then n_stim
// (0: no forcing, null pointers), n_cols and var1 (rhs_common.cuh::
// with_box_stim; ops/kernel_common.py::stim_args with box=True).
#define CRD_BOX_STIM_ARGS                                                    \
  const void *amps, const void *rows, const void *cols, const void *z,      \
      int n_stim, int n_cols, int var1
#define CRD_BOX_STIM_PASS amps, rows, cols, z, n_stim, n_cols, var1
