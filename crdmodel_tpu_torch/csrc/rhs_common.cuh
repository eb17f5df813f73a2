// Device functions shared by the port's fused step kernels (K1
// fused_step.cu, K2 fused_rkc.cu, K3 fused_imex.cu, K4 fused_divform.cu,
// K5 fused_aniso.cu and the shard kernels K8-K11): the grid policies, the
// 5-point profile, divergence-form and 9-point anisotropic operators on
// variable 0, the kinetics of each family and their closed-form
// Jacobians (the six beyond the base three of any shape: Family,
// kinetics_n, jacobian_n, FamilyRhs), the RHS at one point of a tile held
// in shared memory, the
// structured forcing of K1-K4 and K8-K11 (StimTable) and of the box
// kernels K6, K7, K12 and K13 (BoxStimTable) and the per-block partial sum.
// Counterpart of crdmodel_tpu/ops/kernel_common.py::make_rhs_block,
// make_split_block and make_divform_rhs_block and of the operator of
// crdmodel_tpu/ops/pallas_aniso.py; the plain torch versions are
// ops/kernel_common.py::make_rhs_block, make_split_block,
// make_divform_rhs_block and make_aniso_rhs_block and the models/*.py
// kinetics and Jacobians, and the expressions below keep their
// association order, so that a kernel built
// with -fmad=false rounds as PyTorch does. The constants fold in double,
// as the Python expressions fold before they meet a tensor, and are cast
// to T once.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace crd {

// A quiet NaN of T: the partial sums of a step the kernel refuses (an RKC2
// stage count outside its tables), which the adaptive loop rejects.
template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// The kinetics families with a device function; the ids are
// ops/kernel_common.py::KINETICS_IDS.
enum Kinetics {
  kFhn = 0,
  kGoldbeter = 1,
  kAlievPanfilov = 2,
  kBarkley = 3,
  kOregonator = 4,
  kGrayScott = 5,
  kBrusselator = 6,
  kLambdaOmega = 7,
  kSir = 8
};

// A set of families a launcher instantiates
template <int... Ids>
struct KineticsSet {
  static bool has(int id) { return ((id == Ids) || ...); }
};
// the families every kernel takes (ops/kernel_common.py::BASE_FAMILIES)
using BaseFamilies = KineticsSet<kFhn, kGoldbeter, kAlievPanfilov>;
// the families K1, K2's profile branch, K3, K8, K9 and K10 also take,
// unforced, in translation units of their own (fused_*_families.cu;
// NEW_FAMILIES)
using NewFamilies = KineticsSet<kBarkley, kOregonator, kGrayScott,
                                kBrusselator, kLambdaOmega, kSir>;

inline bool valid_kinetics(int id) { return BaseFamilies::has(id); }

// go(kin) for a kinetics id of the set, kin its std::integral_constant;
// cudaErrorInvalidValue for any other id
template <int... Ids, class F>
inline int with_kinetics_in(KineticsSet<Ids...>, int kinetics, F go) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)((kinetics == Ids
              ? (rc = go(std::integral_constant<int, Ids>{}), true)
              : false)
         || ...);
  return rc;
}

// with_kinetics_in over the base families
template <class F>
inline int with_kinetics(int kinetics, F go) {
  return with_kinetics_in(BaseFamilies{}, kinetics, go);
}

constexpr double kFhnEpsilon = 0.36;   // models/fhn.py EPSILON

// models/goldbeter.py constants, and the products its expressions fold
constexpr double kGbV0 = 1.0;
constexpr double kGbK = 10.0;
constexpr double kGbKF = 1.0;
constexpr double kGbV1 = 7.3;
constexpr double kGbVM2 = 65.0;
constexpr double kGbVM3 = 500.0;
constexpr double kGbK2sq = 1.0 * 1.0;            // K2 * K2
constexpr double kGbKRsq = 2.0 * 2.0;            // KR * KR
constexpr double kGbKA4 = 0.6561;    // KA ** 4, Python's pow(0.9, 4) in double
constexpr double kGbDv2 = 2.0 * 65.0 * (1.0 * 1.0);   // 2 VM2 (K2 K2)
constexpr double kGbDv3z = 4.0 * 500.0;               // 4 VM3
constexpr double kGbDv3y = 2.0 * 500.0;               // 2 VM3

// models/aliev_panfilov.py constants
constexpr double kApK = 8.0;
constexpr double kApEps0 = 0.002;
constexpr double kApMu1 = 0.2;
constexpr double kApMu2 = 0.3;

// models/barkley.py, oregonator.py, grayscott.py, brusselator.py and
// sir.py constants, the reciprocals folded in double as there
constexpr double kBkInvEps = 1.0 / 0.02;   // 1 / EPS
constexpr double kBkInvA = 1.0 / 0.75;     // 1 / A
constexpr double kOrInvEps = 1.0 / 0.04;
constexpr double kOrQ = 0.002;
constexpr double kGsK = 0.062;             // K_REMOVAL
constexpr double kBrA = 1.0;               // A_FEED
constexpr double kBrRatio = 8.0;           // D_RATIO_V
constexpr double kSirG = 0.5;              // G_RECOVERY

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// The grid a kernel's tile reads. The tile's region covers points (gy, gx)
// that may lie up to its halo outside the extent the tiles cover; at(gy,
// gx) is a point's offset in one variable's plane of the state, plane()
// that plane's size, row(gy) and col(gx) the indices of the point into the
// RHS's row and column constants (beta, the freeze mask, the profiles), and
// counted(gy, gx) whether a point of the extent enters the error sum. The
// field operators index their coefficient fields, which have the state's
// plane layout, by such row and column indices: field(r, c) is the offset
// of (r, c), north(r), south(r), east(c) and west(c) its neighbours'
// indices.
//
// WrapGrid: the periodic ny x nx grid of the single-device kernels; the
// wrap is a modular index.
struct WrapGrid {
  int ny;
  int nx;

  __device__ __forceinline__ int row(int gy) const { return wrap(gy, ny); }
  __device__ __forceinline__ int col(int gx) const { return wrap(gx, nx); }
  __device__ __forceinline__ size_t field(int r, int c) const {
    return static_cast<size_t>(r) * nx + c;
  }
  __device__ __forceinline__ size_t at(int gy, int gx) const {
    return field(row(gy), col(gx));
  }
  __device__ __forceinline__ size_t plane() const {
    return static_cast<size_t>(ny) * nx;
  }
  __device__ __forceinline__ int north(int r) const {
    return r == ny - 1 ? 0 : r + 1;
  }
  __device__ __forceinline__ int south(int r) const {
    return r == 0 ? ny - 1 : r - 1;
  }
  __device__ __forceinline__ int east(int c) const {
    return c == nx - 1 ? 0 : c + 1;
  }
  __device__ __forceinline__ int west(int c) const {
    return c == 0 ? nx - 1 : c - 1;
  }
  __device__ __forceinline__ bool counted(int, int) const { return true; }
};

// HaloGrid: one shard's nyl x nxl block stored inside a halo of `halo`
// rings, (nyl + 2 halo) x (nxl + 2 halo), which the exchange filled
// (parallel/halo.py::refresh_halos): no index wraps. The constants are the
// shard's, halo-padded the same way (ops/kernel_common.py::
// make_shard_constants, make_shard_divform_constants). On a padded mesh
// only the first valid_rows x valid_cols points of the block are physical;
// the others are mirror-pad cells, stepped like their sources and left out
// of the error sum. A tile's region reaches at most `halo` rings before the
// block's start, but the last tiles' regions can reach further than `halo`
// past its end; those points, and a field operator's neighbours past the
// buffer's edge, are clamped onto the buffer's last (first) row or column.
// They feed only points at least `halo` - n rings beyond the block (n <=
// halo the rings a step consumes), none of which is written.
struct HaloGrid {
  int nyl;
  int nxl;
  int halo;
  int valid_rows;
  int valid_cols;

  __device__ __forceinline__ int row(int gy) const {
    return min(gy + halo, nyl + 2 * halo - 1);
  }
  __device__ __forceinline__ int col(int gx) const {
    return min(gx + halo, nxl + 2 * halo - 1);
  }
  __device__ __forceinline__ size_t field(int r, int c) const {
    return static_cast<size_t>(r) * (nxl + 2 * halo) + c;
  }
  __device__ __forceinline__ size_t at(int gy, int gx) const {
    return field(row(gy), col(gx));
  }
  __device__ __forceinline__ size_t plane() const {
    return static_cast<size_t>(nyl + 2 * halo) * (nxl + 2 * halo);
  }
  __device__ __forceinline__ int north(int r) const {
    return min(r + 1, nyl + 2 * halo - 1);
  }
  __device__ __forceinline__ int south(int r) const { return max(r - 1, 0); }
  __device__ __forceinline__ int east(int c) const {
    return min(c + 1, nxl + 2 * halo - 1);
  }
  __device__ __forceinline__ int west(int c) const { return max(c - 1, 0); }
  __device__ __forceinline__ bool counted(int gy, int gx) const {
    return gy < valid_rows && gx < valid_cols;
  }
};

// The RHS's constant inputs, all on the device: the stencil (three (nx,)
// profiles on the torus, three scalars on the flat surface), beta (a
// scalar or an (ny,) field) and the (ny,) interior-row mask.
template <typename T>
struct RhsConstants {
  const T* c0;
  const T* c1;
  const T* c2;
  int torus;
  const T* beta;
  int beta_field;
  const T* mask;
  int has_freeze;
};

// The structured forcing of K1, K2, K3 and K4 and of the shard kernels
// K8-K11 (core/forcing.py::SeparableForcing, every stimulus rank-1;
// ops/kernel_common.py::StimConstants): stimulus j adds
// (amps[j][a] * rows[j][r]) * cols[j][c] to the right-hand side of its
// variable at the point of row and column indices (r, c), a being the
// amplitude column of the evaluation (a stage of the step). The amplitudes are computed on the device before the
// launch (ops/kernel_common.py::stage_amplitudes) and read here from
// device memory, like the profiles, through the read-only data cache.
// Each variable's forcing adds its stimuli in order from +0.0, as
// ops/kernel_common.py::stim_terms; the right-hand side then takes
// kinetics + (operator + f_u) and kinetics + f_v, before the freeze's
// live factor and the tissue field (the torch path's make_rhs). On a
// shard (HaloGrid) ny and nx are the halo-padded buffer's extents and the
// profiles are halo-padded like the shard's other constants
// (ops/kernel_common.py::prepare_shard_stim_constants), so a ring point
// reads them at the buffer index its state comes from. A kernel without
// a forcing takes NoStim, which compiles all of it out.
constexpr int kStimMaskBits = 31;  // var1's bits (STIM_MASK_BITS)

struct NoStim {
  static constexpr bool kOn = false;
};

template <typename T>
struct StimTable {
  static constexpr bool kOn = true;
  const T* amps;   // (n, n_cols)
  const T* rows;   // (n, ny)
  const T* cols;   // (n, nx)
  int n;
  int n_cols;
  int ny;
  int nx;
  int var1;        // bit j: stimulus j drives variable 1, else variable 0

  // (f_u, f_v) at amplitude column a and row and column indices (r, c)
  __device__ __forceinline__ void at(int a, int r, int c, T& fu,
                                     T& fv) const {
    fu = T(0);
    fv = T(0);
    for (int j = 0; j < n; ++j) {
      const T x = __ldg(amps + j * n_cols + a) * __ldg(rows + j * ny + r)
                  * __ldg(cols + j * nx + c);
      if ((var1 >> j) & 1)
        fv = fv + x;
      else
        fu = fu + x;
    }
  }
};

// A StimTable from the launchers' arguments, or false when they are not
// one (more stimuli than var1 has bits, a missing table)
template <typename T>
inline bool make_stim_table(const void* amps, const void* rows,
                            const void* cols, int n_stim, int n_cols,
                            int var1, int ny, int nx, StimTable<T>* out) {
  if (n_stim < 1 || n_stim > kStimMaskBits || n_cols < 1 || amps == nullptr
      || rows == nullptr || cols == nullptr)
    return false;
  *out = {static_cast<const T*>(amps), static_cast<const T*>(rows),
          static_cast<const T*>(cols), n_stim, n_cols, ny, nx, var1};
  return true;
}

// go(stim) with a launch's forcing: NoStim when n_stim is 0, else the
// StimTable of its arguments over profiles of ny and nx entries;
// cudaErrorInvalidValue when n_cols is not a count the kernel takes
// (n_cols_ok) or the arguments make no table
template <typename T, class F>
inline int with_stim(const void* amps, const void* rows, const void* cols,
                     int n_stim, int n_cols, int var1, bool n_cols_ok,
                     int ny, int nx, F go) {
  if (n_stim == 0) return go(NoStim{});
  StimTable<T> stim;
  if (!n_cols_ok
      || !make_stim_table(amps, rows, cols, n_stim, n_cols, var1, ny, nx,
                          &stim))
    return static_cast<int>(cudaErrorInvalidValue);
  return go(stim);
}

// The structured forcing of the 3-D box kernels (K6, K7, K12, K13;
// ops/kernel_common.py::StimConstants with its z table): StimTable's rank-1
// rows and columns and an (n, nz) depth table z, ones where a stimulus has
// no depth profile (core/forcing.py::Stimulus.zprof). Stimulus j adds
// ((amps[j][a] * z[j][k]) * rows[j][r]) * cols[j][c] at plane k, the JAX
// box kernels' association (crdmodel_tpu/ops/pallas_box3d.py:660-662).
// z is not sharded: a shard's table is the whole box's, its rows and
// columns halo-padded like StimTable's on a shard.
template <typename T>
struct BoxStimTable {
  static constexpr bool kOn = true;
  StimTable<T> s;
  const T* z;      // (n, nz)
  int nz;

  // (f_u, f_v) at amplitude column a, plane k and row and column indices
  // (r, c)
  __device__ __forceinline__ void at(int a, int k, int r, int c, T& fu,
                                     T& fv) const {
    fu = T(0);
    fv = T(0);
    for (int j = 0; j < s.n; ++j) {
      const T x = __ldg(s.amps + j * s.n_cols + a) * __ldg(z + j * nz + k)
                  * __ldg(s.rows + j * s.ny + r)
                  * __ldg(s.cols + j * s.nx + c);
      if ((s.var1 >> j) & 1)
        fv = fv + x;
      else
        fu = fu + x;
    }
  }
};

// go(stim) with a box launch's forcing: NoStim when n_stim is 0, else the
// BoxStimTable of its arguments over a depth table of nz planes and
// profiles of ny and nx entries; cudaErrorInvalidValue as with_stim, or
// when the depth table is missing or nz < 1
template <typename T, class F>
inline int with_box_stim(const void* amps, const void* rows,
                         const void* cols, const void* z, int n_stim,
                         int n_cols, int var1, bool n_cols_ok, int nz,
                         int ny, int nx, F go) {
  if (n_stim == 0) return go(NoStim{});
  BoxStimTable<T> stim;
  if (!n_cols_ok || z == nullptr || nz < 1
      || !make_stim_table(amps, rows, cols, n_stim, n_cols, var1, ny, nx,
                          &stim.s))
    return static_cast<int>(cudaErrorInvalidValue);
  stim.z = static_cast<const T*>(z);
  stim.nz = nz;
  return go(stim);
}

// The amplitude column of an RKC2 step's RHS evaluation e (0: F0 and Y1;
// e in 1..s-1: f(Y_e); s: F1) in an amplitude table of n_cols columns: 0
// with one column (every stimulus segment-gated), else the stage-time
// index of ops/fused_rkc.py::static_stage_tables(with_times=True), 0 for
// F0 and e + 1 after (K2, K7, K9, K13)
__host__ __device__ __forceinline__ int rkc_amp_column(int e, int n_cols) {
  return n_cols == 1 || e == 0 ? 0 : e + 1;
}

// kinetics (du, dv) plus the operator's lap on variable 0 and, forced,
// kinetics + (lap + fu) and kinetics + fv
template <bool kForced, typename T>
__device__ __forceinline__ void add_operator(T lap, T fu, T fv, T& du,
                                             T& dv) {
  if constexpr (kForced) {
    du = du + (lap + fu);
    dv = dv + fv;
  } else {
    du = du + lap;
  }
}

// The profile operator at local point p of a region with row stride W
// holding variable 0; gx is p's global column.
template <typename T>
__device__ __forceinline__ T profile_lap(const RhsConstants<T>& k,
                                         const T* su, int p, int W, int gx) {
  const T u = su[p];
  const T uw = su[p - 1], ue = su[p + 1];
  const T us = su[p - W], un = su[p + W];
  if (k.torus)
    return k.c0[gx] * (ue - uw) + k.c1[gx] * (ue - T(2) * u + uw)
           + k.c2[gx] * (un - T(2) * u + us);
  return k.c0[0] * (uw + ue) + k.c1[0] * (us + un) + k.c2[0] * u;
}

// profile_lap on the coefficients c0, c1, c2 read before (those of p's
// column on the torus, the scalars on the flat surface): the same
// operations in the same order
template <typename T>
__device__ __forceinline__ T profile_lap_of(T c0, T c1, T c2, bool torus,
                                            const T* su, int p, int W) {
  const T u = su[p];
  const T uw = su[p - 1], ue = su[p + 1];
  const T us = su[p - W], un = su[p + W];
  if (torus)
    return c0 * (ue - uw) + c1 * (ue - T(2) * u + uw)
           + c2 * (un - T(2) * u + us);
  return c0 * (uw + ue) + c1 * (us + un) + c2 * u;
}

template <typename T>
__device__ __forceinline__ T beta_at(const RhsConstants<T>& k, int gy) {
  return k.beta_field ? k.beta[gy] : k.beta[0];
}

// live = 1 - fz*(1 - mask) on row gy: 0 on a frozen edge row, else 1
template <typename T>
__device__ __forceinline__ T live_at(const RhsConstants<T>& k, T fz, int gy) {
  return T(1) - fz * (T(1) - k.mask[gy]);
}

// The kinetics (du, dv) = f(u, v; b): models/fhn.py, models/goldbeter.py
// and models/aliev_panfilov.py::kinetics.
template <int Kin, typename T>
__device__ __forceinline__ void kinetics(T u, T v, T b, T& du, T& dv) {
  if (Kin == kFhn) {
    du = T(3) * u - u * u * u - v;
    dv = static_cast<T>(kFhnEpsilon) * (u + b);
  } else if (Kin == kAlievPanfilov) {
    const T k = static_cast<T>(kApK);
    const T eps = static_cast<T>(kApEps0)
                  + static_cast<T>(kApMu1) * v / (u + static_cast<T>(kApMu2));
    du = k * u * (T(1) - u) * (u - b) - u * v;
    dv = eps * (-v - k * u * (u - b - T(1)));
  } else {
    const T Z = u, Y = v;
    const T Zn = Z * Z;
    const T v2 = static_cast<T>(kGbVM2) * Zn / (static_cast<T>(kGbK2sq) + Zn);
    const T Ym = Y * Y;
    const T Z2 = Z * Z;
    const T Zp = Z2 * Z2;
    const T v3 = static_cast<T>(kGbVM3) * Ym * Zp
                 / ((static_cast<T>(kGbKRsq) + Ym)
                    * (static_cast<T>(kGbKA4) + Zp));
    du = static_cast<T>(kGbV0) + static_cast<T>(kGbV1) * b - v2 + v3
         + static_cast<T>(kGbKF) * Y - static_cast<T>(kGbK) * Z;
    dv = v2 - v3 - static_cast<T>(kGbKF) * Y;
  }
}

// The kinetics Jacobian j = [[j00, j01], [j10, j11]] at (u, v; b):
// models/fhn.py, models/goldbeter.py and models/aliev_panfilov.py::jacobian
// (b enters only Aliev-Panfilov's).
template <int Kin, typename T>
__device__ __forceinline__ void jacobian(T u, T v, T b, T& j00, T& j01,
                                         T& j10, T& j11) {
  if (Kin == kFhn) {
    j00 = T(3) - T(3) * (u * u);
    j01 = T(-1);
    j10 = static_cast<T>(kFhnEpsilon);
    j11 = T(0);
  } else if (Kin == kAlievPanfilov) {
    const T k = static_cast<T>(kApK);
    const T mu1 = static_cast<T>(kApMu1);
    const T d = u + static_cast<T>(kApMu2);
    const T eps = static_cast<T>(kApEps0) + mu1 * v / d;
    const T w = -v - k * u * (u - b - T(1));
    j00 = k * ((T(1) - u) * (u - b) + u * ((T(1) - u) - (u - b))) - v;
    j01 = -u;
    j10 = eps * (-k) * (T(2) * u - b - T(1)) - (mu1 * v / (d * d)) * w;
    j11 = -eps + mu1 * w / d;
  } else {
    const T Z = u, Y = v;
    const T Z2 = Z * Z;
    const T Z4 = Z2 * Z2;
    const T Y2 = Y * Y;
    const T dz = static_cast<T>(kGbK2sq) + Z2;
    const T dv2 = static_cast<T>(kGbDv2) * Z / (dz * dz);
    const T gY = Y2 / (static_cast<T>(kGbKRsq) + Y2);
    const T gZ = Z4 / (static_cast<T>(kGbKA4) + Z4);
    const T ez = static_cast<T>(kGbKA4) + Z4;
    const T dv3z = static_cast<T>(kGbDv3z) * gY * static_cast<T>(kGbKA4) * Z
                   * Z2 / (ez * ez);
    const T ey = static_cast<T>(kGbKRsq) + Y2;
    const T dv3y = static_cast<T>(kGbDv3y) * gZ * static_cast<T>(kGbKRsq) * Y
                   / (ey * ey);
    j00 = -dv2 + dv3z - static_cast<T>(kGbK);
    j01 = dv3y + static_cast<T>(kGbKF);
    j10 = dv2 - dv3z;
    j11 = -dv3y - static_cast<T>(kGbKF);
  }
}

// ydot = f(u, v) at local point p of a region with row stride W, whose
// global indices are (gy, gx), v the point's variable 1 (only variable 0
// is read at neighbours); fz is the freeze scalar of the segment.
template <int Kin, typename T, bool kForced = false>
__device__ __forceinline__ void profile_rhs_v(
    const RhsConstants<T>& k, T fz, const T* su, T v, int p, int W, int gy,
    int gx, T& du_out, T& dv_out, T fu = T(0), T fv = T(0)) {
  const T lap = profile_lap(k, su, p, W, gx);
  T du, dv;
  kinetics<Kin>(su[p], v, beta_at(k, gy), du, dv);
  add_operator<kForced>(lap, fu, fv, du, dv);
  if (k.has_freeze) {
    const T live = live_at(k, fz, gy);
    du = du * live;
    dv = dv * live;
  }
  du_out = du;
  dv_out = dv;
}

// The profile operator's coefficients at one point, read once a launch by
// the register-resident tile kernels (erk_slots.cuh): the three profiles
// at the point's column (torus) or the three scalars (flat), and beta and
// live of the point's row (live 1 without a freeze).
template <typename T>
struct ProfilePoint {
  T c0;
  T c1;
  T c2;
  T beta;
  T live;
};

// profile_rhs_v on a point's coefficients read before (ProfilePoint), the
// same operations in the same order (profile_lap's); torus and freeze say
// whether the operator takes the torus's profiles and whether the run has
// a freeze; kForced adds the point's forcing (fu, fv)
template <int Kin, typename T, bool kForced = false>
__device__ __forceinline__ void profile_point_rhs(
    const ProfilePoint<T>& c, bool torus, bool freeze, const T* su, T v,
    int p, int W, T& du_out, T& dv_out, T fu = T(0), T fv = T(0)) {
  const T lap = profile_lap_of(c.c0, c.c1, c.c2, torus, su, p, W);
  T du, dv;
  kinetics<Kin>(su[p], v, c.beta, du, dv);
  add_operator<kForced>(lap, fu, fv, du, dv);
  if (freeze) {
    du = du * c.live;
    dv = dv * c.live;
  }
  du_out = du;
  dv_out = dv;
}

// profile_rhs_v as the functor the tile kernels take (erk_tile.cuh,
// erk_slots.cuh, fused_rkc.cu, fused_kstep.cu): operator() reads v at p of
// the region sv, at() takes it by value; point() reads the coefficients of
// the point of row and column indices (r, c) once, at_point() evaluates on
// them; each with (fu, fv) before the outputs adds the point's forcing
template <int Kin, typename T>
struct ProfileRhs {
  // shared planes the operator reads at neighbours (erk_slots.cuh): none
  static constexpr int kPlanes = 0;
  using Point = ProfilePoint<T>;

  RhsConstants<T> k;

  __device__ __forceinline__ void operator()(T fz, const T* su, const T* sv,
                                             int p, int W, int gy, int gx,
                                             T& du, T& dv) const {
    profile_rhs_v<Kin>(k, fz, su, sv[p], p, W, gy, gx, du, dv);
  }
  __device__ __forceinline__ void at(T fz, const T* su, T v, int p, int W,
                                     int gy, int gx, T& du, T& dv) const {
    profile_rhs_v<Kin>(k, fz, su, v, p, W, gy, gx, du, dv);
  }
  __device__ __forceinline__ void operator()(T fz, const T* su, const T* sv,
                                             int p, int W, int gy, int gx,
                                             T fu, T fv, T& du,
                                             T& dv) const {
    profile_rhs_v<Kin, T, true>(k, fz, su, sv[p], p, W, gy, gx, du, dv, fu,
                                fv);
  }
  __device__ __forceinline__ Point point(T fz, size_t, size_t, int r,
                                         int c) const {
    const int i = k.torus ? c : 0;
    return {__ldg(k.c0 + i), __ldg(k.c1 + i), __ldg(k.c2 + i),
            beta_at(k, r), k.has_freeze ? live_at(k, fz, r) : T(1)};
  }
  __device__ __forceinline__ T plane(int, size_t) const { return T(0); }
  __device__ __forceinline__ void at_point(const Point& c, const T*,
                                           const T* su, T v, int p, int W,
                                           T& du, T& dv) const {
    profile_point_rhs<Kin>(c, k.torus != 0, k.has_freeze != 0, su, v, p, W,
                           du, dv);
  }
  __device__ __forceinline__ void at_point(const Point& c, const T*,
                                           const T* su, T v, int p, int W,
                                           T fu, T fv, T& du, T& dv) const {
    profile_point_rhs<Kin, T, true>(c, k.torus != 0, k.has_freeze != 0, su,
                                    v, p, W, du, dv, fu, fv);
  }
};

// The shape of a family (the model's nvars, diffusive_vars and
// diffusion_ratios; ops/kernel_common.py::NEW_FAMILIES): kNv variables,
// kNd of which diffuse, the i-th being variable var(i) at ratio(i) times
// the coefficient. The base families and Barkley and the Oregonator: two
// variables, variable 0 alone diffusing at ratio 1.
template <int Kin>
struct Family {
  static constexpr int kNv = 2;
  static constexpr int kNd = 1;
  __host__ __device__ static constexpr int var(int) { return 0; }
  __host__ __device__ static constexpr double ratio(int) { return 1.0; }
};
template <>
struct Family<kGrayScott> {
  static constexpr int kNv = 2;
  static constexpr int kNd = 2;
  __host__ __device__ static constexpr int var(int i) { return i; }
  __host__ __device__ static constexpr double ratio(int i) {
    return i == 0 ? 1.0 : 0.5;
  }
};
template <>
struct Family<kBrusselator> {
  static constexpr int kNv = 2;
  static constexpr int kNd = 2;
  __host__ __device__ static constexpr int var(int i) { return i; }
  __host__ __device__ static constexpr double ratio(int i) {
    return i == 0 ? 1.0 : kBrRatio;
  }
};
template <>
struct Family<kLambdaOmega> {
  static constexpr int kNv = 2;
  static constexpr int kNd = 2;
  __host__ __device__ static constexpr int var(int i) { return i; }
  __host__ __device__ static constexpr double ratio(int) { return 1.0; }
};
template <>
struct Family<kSir> {
  static constexpr int kNv = 3;
  static constexpr int kNd = 1;
  __host__ __device__ static constexpr int var(int) { return 1; }
  __host__ __device__ static constexpr double ratio(int) { return 1.0; }
};

// Variable v diffuses in the family
template <int Kin>
__host__ __device__ constexpr bool family_diffuses(int v) {
  for (int i = 0; i < Family<Kin>::kNd; ++i)
    if (Family<Kin>::var(i) == v) return true;
  return false;
}

// The kinetics dy = f(y; b) of a family beyond the base three, y and dy
// of Family<Kin>::kNv variables: models/barkley.py, oregonator.py,
// grayscott.py, brusselator.py, lambdaomega.py and sir.py::kinetics.
template <int Kin, typename T>
__device__ __forceinline__ void kinetics_n(const T* y, T b, T* dy) {
  if constexpr (Kin == kBarkley) {
    const T u = y[0], v = y[1];
    dy[0] = static_cast<T>(kBkInvEps) * u * (T(1) - u)
            * (u - (v + b) * static_cast<T>(kBkInvA));
    dy[1] = u - v;
  } else if constexpr (Kin == kOregonator) {
    const T u = y[0], v = y[1];
    const T q = static_cast<T>(kOrQ);
    dy[0] = static_cast<T>(kOrInvEps)
            * (u * (T(1) - u) - b * v * (u - q) / (u + q));
    dy[1] = u - v;
  } else if constexpr (Kin == kGrayScott) {
    const T u = y[0], v = y[1];
    const T uvv = u * v * v;
    dy[0] = -uvv + b * (T(1) - u);
    dy[1] = uvv - (b + static_cast<T>(kGsK)) * v;
  } else if constexpr (Kin == kBrusselator) {
    const T u = y[0], v = y[1];
    const T uuv = u * u * v;
    dy[0] = static_cast<T>(kBrA) - (b + T(1)) * u + uuv;
    dy[1] = b * u - uuv;
  } else if constexpr (Kin == kLambdaOmega) {
    const T u = y[0], v = y[1];
    const T r2 = u * u + v * v;
    dy[0] = (T(1) - r2) * u + b * r2 * v;
    dy[1] = -b * r2 * u + (T(1) - r2) * v;
  } else {
    static_assert(Kin == kSir, "a family beyond the base three");
    const T inf = b * y[0] * y[1];
    const T rec = static_cast<T>(kSirG) * y[1];
    dy[0] = -inf;
    dy[1] = inf - rec;
    dy[2] = rec;
  }
}

// The kinetics Jacobian j[r][c] = d f_r / d y_c of a family beyond the
// base three: models/*.py::jacobian of the families of kinetics_n.
template <int Kin, typename T, int N = Family<Kin>::kNv>
__device__ __forceinline__ void jacobian_n(const T* y, T b, T (&j)[N][N]) {
  if constexpr (Kin == kBarkley) {
    const T u = y[0], v = y[1];
    const T ie = static_cast<T>(kBkInvEps);
    const T thr = (v + b) * static_cast<T>(kBkInvA);
    j[0][0] = ie * ((T(1) - T(2) * u) * (u - thr) + u * (T(1) - u));
    j[0][1] = -(ie * u * (T(1) - u) * static_cast<T>(kBkInvA));
    j[1][0] = T(1);
    j[1][1] = T(-1);
  } else if constexpr (Kin == kOregonator) {
    const T u = y[0], v = y[1];
    const T ie = static_cast<T>(kOrInvEps);
    const T q = static_cast<T>(kOrQ);
    const T upq = u + q;
    j[0][0] = ie * (T(1) - T(2) * u - b * v * T(2) * q / (upq * upq));
    j[0][1] = -(ie * (b * (u - q) / upq));
    j[1][0] = T(1);
    j[1][1] = T(-1);
  } else if constexpr (Kin == kGrayScott) {
    const T u = y[0], v = y[1];
    const T vv = v * v;
    const T uv2 = T(2) * (u * v);
    j[0][0] = -vv - b;
    j[0][1] = -uv2;
    j[1][0] = vv;
    j[1][1] = uv2 - (b + static_cast<T>(kGsK));
  } else if constexpr (Kin == kBrusselator) {
    const T u = y[0], v = y[1];
    const T uv2 = T(2) * (u * v);
    const T uu = u * u;
    j[0][0] = uv2 - (b + T(1));
    j[0][1] = uu;
    j[1][0] = b - uv2;
    j[1][1] = -uu;
  } else if constexpr (Kin == kLambdaOmega) {
    const T u = y[0], v = y[1];
    const T r2 = u * u + v * v;
    const T m = T(1) - r2;
    const T tu = T(2) * u, tv = T(2) * v;
    j[0][0] = m - tu * u + b * tu * v;
    j[0][1] = -(tv * u) + b * (r2 + tv * v);
    j[1][0] = -b * (r2 + tu * u) - tu * v;
    j[1][1] = -b * tv * u + m - tv * v;
  } else {
    static_assert(Kin == kSir, "a family beyond the base three");
    const T bi = b * y[1];
    const T bs = b * y[0];
    j[0][0] = -bi;
    j[0][1] = -bs;
    j[0][2] = T(0);
    j[1][0] = bi;
    j[1][1] = bs - static_cast<T>(kSirG);
    j[1][2] = T(0);
    j[2][0] = T(0);
    j[2][1] = static_cast<T>(kSirG);
    j[2][2] = T(0);
  }
}

// The profile operator with the kinetics of a family beyond the base three
// (ops/kernel_common.py::make_rhs_block on its NEW_FAMILIES), the functor
// of the families' tile kernels (erk_slots.cuh, erk_tile.cuh,
// rkc_chunk.cuh): point() reads a point's coefficients once, as
// ProfileRhs's; at_point() writes dy at local point p (row stride W) from
// the point's variables y and the planes of its diffusing variables
// (planes[i] holds variable Fam::var(i)): the kinetics, plus each
// diffusing variable's operator, times its ratio after the stencil where
// the ratio is not 1 (react[v] + laps[v]), then times live with a freeze.
template <int Kin, typename T>
struct FamilyRhs {
  using Fam = Family<Kin>;
  using Point = ProfilePoint<T>;
  static constexpr int kNv = Fam::kNv;
  static constexpr int kNd = Fam::kNd;

  RhsConstants<T> k;

  __device__ __forceinline__ Point point(T fz, int r, int c) const {
    const int i = k.torus ? c : 0;
    return {__ldg(k.c0 + i), __ldg(k.c1 + i), __ldg(k.c2 + i),
            beta_at(k, r), k.has_freeze ? live_at(k, fz, r) : T(1)};
  }
  // the operator on diffusing variable i (its plane su) at p, its ratio
  // applied
  __device__ __forceinline__ T lap(const Point& c, int i, const T* su,
                                   int p, int W) const {
    const T l = profile_lap_of(c.c0, c.c1, c.c2, k.torus != 0, su, p, W);
    return Fam::ratio(i) == 1.0 ? l : static_cast<T>(Fam::ratio(i)) * l;
  }
  __device__ __forceinline__ void at_point(const Point& c,
                                           const T* const* planes,
                                           const T* y, int p, int W,
                                           T* dy) const {
    kinetics_n<Kin>(y, c.beta, dy);
#pragma unroll
    for (int i = 0; i < kNd; ++i)
      dy[Fam::var(i)] = dy[Fam::var(i)] + lap(c, i, planes[i], p, W);
    if (k.has_freeze) {
#pragma unroll
      for (int v = 0; v < kNv; ++v) dy[v] = dy[v] * c.live;
    }
  }
};

// The divergence-form operator's inputs: the face coefficients aE, aW, aN
// as fields of the grid's plane layout (aS at (r, c) is aN at (south(r),
// c)) and the 0/1 tissue field, or nullptr without an obstacle. All read
// through the read-only data cache.
template <typename T>
struct FaceConstants {
  const T* aE;
  const T* aW;
  const T* aN;
  const T* tissue;
};

// ydot at local point p (row stride W) of row and column indices (gy, gx)
// of `grid`, v the point's variable 1, under the divergence-form operator
// on variable 0
// (ops/kernel_common.py::make_divform_rhs_block, make_shard_divform_rhs_
// block): kinetics + aE(uE-u) + aW(uW-u) + aN(uN-u) + aS(uS-u), times live
// with a freeze, times the tissue field with an obstacle. Closed faces
// carry zero coefficients, so the halo values they meet contribute exact
// zeros.
template <int Kin, typename T, class Grid, bool kForced = false>
__device__ __forceinline__ void divform_rhs(
    const FaceConstants<T>& f, const RhsConstants<T>& k, const Grid& grid,
    T fz, const T* su, T v, int p, int W, int gy, int gx, T& du_out,
    T& dv_out, T fu = T(0), T fv = T(0)) {
  const size_t g = grid.field(gy, gx);
  const size_t gs = grid.field(grid.south(gy), gx);
  const T u = su[p];
  const T lap = __ldg(f.aE + g) * (su[p + 1] - u)
                + __ldg(f.aW + g) * (su[p - 1] - u)
                + __ldg(f.aN + g) * (su[p + W] - u)
                + __ldg(f.aN + gs) * (su[p - W] - u);
  T du, dv;
  kinetics<Kin>(u, v, beta_at(k, gy), du, dv);
  add_operator<kForced>(lap, fu, fv, du, dv);
  if (k.has_freeze) {
    const T live = live_at(k, fz, gy);
    du = du * live;
    dv = dv * live;
  }
  if (f.tissue != nullptr) {
    const T tis = __ldg(f.tissue + g);
    du = du * tis;
    dv = dv * tis;
  }
  du_out = du;
  dv_out = dv;
}

// The face operators' coefficients at one point, read once a launch by the
// register-resident tile kernels (erk_slots.cuh): aE, aW, aN and aS (aN of
// the row below), x (the tissue field's value, 1 without an obstacle; the
// mixed pair's weight inv4 in the tensor mode), and beta and live of the
// point's row (live 1 without a freeze).
template <typename T>
struct FacePoint {
  T ae;
  T aw;
  T an;
  T as;
  T x;
  T beta;
  T live;
};

// divform_rhs on a point's coefficients read before (FacePoint), the same
// operations in the same order; freeze and tissue say whether the run has
// a freeze and an obstacle; kForced adds the point's forcing (fu, fv)
template <int Kin, typename T, bool kForced = false>
__device__ __forceinline__ void divform_point_rhs(
    const FacePoint<T>& c, bool freeze, bool tissue, const T* su, T v,
    int p, int W, T& du_out, T& dv_out, T fu = T(0), T fv = T(0)) {
  const T u = su[p];
  const T lap = c.ae * (su[p + 1] - u) + c.aw * (su[p - 1] - u)
                + c.an * (su[p + W] - u) + c.as * (su[p - W] - u);
  T du, dv;
  kinetics<Kin>(u, v, c.beta, du, dv);
  add_operator<kForced>(lap, fu, fv, du, dv);
  if (freeze) {
    du = du * c.live;
    dv = dv * c.live;
  }
  if (tissue) {
    du = du * c.x;
    dv = dv * c.x;
  }
  du_out = du;
  dv_out = dv;
}

// divform_rhs as the functor the tile kernels take (erk_tile.cuh,
// fused_rkc.cu, erk_slots.cuh): WrapGrid for K4 and K2's divergence
// branch, HaloGrid for K11's divform mode; operator() reads v at p of the
// region sv, at() takes it by value; point() reads the coefficients of the
// point at field offset g (gs the offset of the row below, r and c its row
// and column indices) once, at_point() evaluates on them; each with
// (fu, fv) before the outputs adds the point's forcing.
template <int Kin, typename T, class Grid>
struct DivformRhs {
  // shared planes the operator reads at neighbours (erk_slots.cuh): none
  static constexpr int kPlanes = 0;
  using Point = FacePoint<T>;

  FaceConstants<T> f;
  RhsConstants<T> k;
  Grid grid;

  __device__ __forceinline__ void operator()(T fz, const T* su, const T* sv,
                                             int p, int W, int gy, int gx,
                                             T& du, T& dv) const {
    divform_rhs<Kin>(f, k, grid, fz, su, sv[p], p, W, gy, gx, du, dv);
  }
  __device__ __forceinline__ void at(T fz, const T* su, T v, int p, int W,
                                     int gy, int gx, T& du, T& dv) const {
    divform_rhs<Kin>(f, k, grid, fz, su, v, p, W, gy, gx, du, dv);
  }
  __device__ __forceinline__ void operator()(T fz, const T* su, const T* sv,
                                             int p, int W, int gy, int gx,
                                             T fu, T fv, T& du,
                                             T& dv) const {
    divform_rhs<Kin, T, Grid, true>(f, k, grid, fz, su, sv[p], p, W, gy, gx,
                                    du, dv, fu, fv);
  }
  __device__ __forceinline__ void at(T fz, const T* su, T v, int p, int W,
                                     int gy, int gx, T fu, T fv, T& du,
                                     T& dv) const {
    divform_rhs<Kin, T, Grid, true>(f, k, grid, fz, su, v, p, W, gy, gx, du,
                                    dv, fu, fv);
  }
  __device__ __forceinline__ FacePoint<T> point(T fz, size_t g, size_t gs,
                                                int r, int) const {
    return {__ldg(f.aE + g),
            __ldg(f.aW + g),
            __ldg(f.aN + g),
            __ldg(f.aN + gs),
            f.tissue != nullptr ? __ldg(f.tissue + g) : T(1),
            beta_at(k, r),
            k.has_freeze ? live_at(k, fz, r) : T(1)};
  }
  __device__ __forceinline__ T plane(int, size_t) const { return T(0); }
  __device__ __forceinline__ void at_point(const FacePoint<T>& c, const T*,
                                           const T* su, T v, int p, int W,
                                           T& du, T& dv) const {
    divform_point_rhs<Kin>(c, k.has_freeze, f.tissue != nullptr, su, v, p,
                           W, du, dv);
  }
  __device__ __forceinline__ void at_point(const FacePoint<T>& c, const T*,
                                           const T* su, T v, int p, int W,
                                           T fu, T fv, T& du, T& dv) const {
    divform_point_rhs<Kin, T, true>(c, k.has_freeze, f.tissue != nullptr,
                                    su, v, p, W, du, dv, fu, fv);
  }
};

// The mixed pair of K11's aniso mode: the raw Dxy field (the grid's plane
// layout) and its weight inv4, a scalar (flat) or a column profile
// (torus), outside the differences.
template <typename T>
struct MixedConstants {
  const T* dxy;
  const T* inv4;
  int inv4_profile;
};

// ydot at local point p (row stride W) of row and column indices (gy, gx)
// under the 2-D tensor operator of the XLA path (ops/stencil.py::
// anisotropic_laplacian; K11's aniso mode, crdmodel_tpu/ops/
// kernel_common.py:196-209):
//   axis = aE(uE-u) + aW(uW-u) + aN(uN-u) + aS(uS-u)
//   t1 = fx(j, i+1) - fx(j, i-1),  fx = Dxy (uN - uS)
//   t2 = fy(j+1, i) - fy(j-1, i),  fy = Dxy (uE - uW)
//   lap = axis + inv4 (t1 + t2)
// then kinetics + lap (kForced: kinetics + (lap + fu) and kinetics + fv),
// times live with a freeze. aniso_rhs (K5) associates axis + (t1 + t2) on
// a folded Dxy*inv4 instead.
template <int Kin, typename T, class Grid, bool kForced = false>
__device__ __forceinline__ void mixed_divform_rhs(
    const FaceConstants<T>& f, const MixedConstants<T>& m,
    const RhsConstants<T>& k, const Grid& grid, T fz, const T* su,
    const T* sv, int p, int W, int gy, int gx, T& du_out, T& dv_out,
    T fu = T(0), T fv = T(0)) {
  const size_t g = grid.field(gy, gx);
  const int rn = grid.north(gy), rs = grid.south(gy);
  const int ce = grid.east(gx), cw = grid.west(gx);
  const T u = su[p];
  const T axis = __ldg(f.aE + g) * (su[p + 1] - u)
                 + __ldg(f.aW + g) * (su[p - 1] - u)
                 + __ldg(f.aN + g) * (su[p + W] - u)
                 + __ldg(f.aN + grid.field(rs, gx)) * (su[p - W] - u);
  const T fx_e = __ldg(m.dxy + grid.field(gy, ce))
                 * (su[p + W + 1] - su[p - W + 1]);
  const T fx_w = __ldg(m.dxy + grid.field(gy, cw))
                 * (su[p + W - 1] - su[p - W - 1]);
  const T fy_n = __ldg(m.dxy + grid.field(rn, gx))
                 * (su[p + W + 1] - su[p + W - 1]);
  const T fy_s = __ldg(m.dxy + grid.field(rs, gx))
                 * (su[p - W + 1] - su[p - W - 1]);
  const T w4 = m.inv4_profile ? __ldg(m.inv4 + gx) : __ldg(m.inv4);
  const T lap = axis + w4 * ((fx_e - fx_w) + (fy_n - fy_s));
  T du, dv;
  kinetics<Kin>(u, sv[p], beta_at(k, gy), du, dv);
  add_operator<kForced>(lap, fu, fv, du, dv);
  if (k.has_freeze) {
    const T live = live_at(k, fz, gy);
    du = du * live;
    dv = dv * live;
  }
  du_out = du;
  dv_out = dv;
}

// mixed_divform_rhs on a point's coefficients read before (FacePoint, x
// the weight inv4) and the raw Dxy in a plane sx of the region's layout,
// the same operations in the same order; kForced adds the point's forcing
// (fu, fv)
template <int Kin, typename T, bool kForced = false>
__device__ __forceinline__ void mixed_point_rhs(
    const FacePoint<T>& c, bool freeze, const T* sx, const T* su, T v,
    int p, int W, T& du_out, T& dv_out, T fu = T(0), T fv = T(0)) {
  const T u = su[p];
  const T axis = c.ae * (su[p + 1] - u) + c.aw * (su[p - 1] - u)
                 + c.an * (su[p + W] - u) + c.as * (su[p - W] - u);
  const T fx_e = sx[p + 1] * (su[p + W + 1] - su[p - W + 1]);
  const T fx_w = sx[p - 1] * (su[p + W - 1] - su[p - W - 1]);
  const T fy_n = sx[p + W] * (su[p + W + 1] - su[p + W - 1]);
  const T fy_s = sx[p - W] * (su[p - W + 1] - su[p - W - 1]);
  const T lap = axis + c.x * ((fx_e - fx_w) + (fy_n - fy_s));
  T du, dv;
  kinetics<Kin>(u, v, c.beta, du, dv);
  add_operator<kForced>(lap, fu, fv, du, dv);
  if (freeze) {
    du = du * c.live;
    dv = dv * c.live;
  }
  du_out = du;
  dv_out = dv;
}

// mixed_divform_rhs as the functor the ERK tile kernels take (K11's aniso
// mode; erk_tile.cuh, erk_slots.cuh); point() and at_point() as
// DivformRhs's, with Dxy, which the operator reads at neighbours, in a
// shared plane (plane(0, g) its value at field offset g); each with
// (fu, fv) before the outputs adds the point's forcing
template <int Kin, typename T, class Grid>
struct MixedDivformRhs {
  static constexpr int kPlanes = 1;
  using Point = FacePoint<T>;

  FaceConstants<T> f;
  MixedConstants<T> m;
  RhsConstants<T> k;
  Grid grid;

  __device__ __forceinline__ void operator()(T fz, const T* su, const T* sv,
                                             int p, int W, int gy, int gx,
                                             T& du, T& dv) const {
    mixed_divform_rhs<Kin>(f, m, k, grid, fz, su, sv, p, W, gy, gx, du, dv);
  }
  __device__ __forceinline__ void operator()(T fz, const T* su, const T* sv,
                                             int p, int W, int gy, int gx,
                                             T fu, T fv, T& du,
                                             T& dv) const {
    mixed_divform_rhs<Kin, T, Grid, true>(f, m, k, grid, fz, su, sv, p, W,
                                          gy, gx, du, dv, fu, fv);
  }
  __device__ __forceinline__ FacePoint<T> point(T fz, size_t g, size_t gs,
                                                int r, int c) const {
    return {__ldg(f.aE + g),
            __ldg(f.aW + g),
            __ldg(f.aN + g),
            __ldg(f.aN + gs),
            m.inv4_profile ? __ldg(m.inv4 + c) : __ldg(m.inv4),
            beta_at(k, r),
            k.has_freeze ? live_at(k, fz, r) : T(1)};
  }
  __device__ __forceinline__ T plane(int, size_t g) const {
    return __ldg(m.dxy + g);
  }
  __device__ __forceinline__ void at_point(const FacePoint<T>& c,
                                           const T* sx, const T* su, T v,
                                           int p, int W, T& du,
                                           T& dv) const {
    mixed_point_rhs<Kin>(c, k.has_freeze, sx, su, v, p, W, du, dv);
  }
  __device__ __forceinline__ void at_point(const FacePoint<T>& c,
                                           const T* sx, const T* su, T v,
                                           int p, int W, T fu, T fv, T& du,
                                           T& dv) const {
    mixed_point_rhs<Kin, T, true>(c, k.has_freeze, sx, su, v, p, W, du, dv,
                                  fu, fv);
  }
};

// The anisotropic operator's inputs: aE, aN and dxyw = Dxy/(4 dx dy) as
// fields of the grid's plane layout, read through the read-only data
// cache. aW at (r, c) is aE at (r, west(c)) and aS is aN at (south(r), c).
template <typename T>
struct TensorConstants {
  const T* aE;
  const T* aN;
  const T* dxyw;
};

// ydot at local point p (row stride W) of row and column indices (gy, gx)
// under the 9-point anisotropic operator on variable 0
// (ops/kernel_common.py::aniso_kernel_laplacian, the TPU kernel's
// association):
//   axis = aE(uE-u) + aW(uW-u) + aN(uN-u) + aS(uS-u)
//   t1 = fx(j, i+1) - fx(j, i-1),  fx = dxyw (uN - uS)
//   t2 = fy(j+1, i) - fy(j-1, i),  fy = dxyw (uE - uW)
//   lap = axis + (t1 + t2)
// then kinetics + lap, times live with a freeze. The fluxes at the four
// neighbours read the diagonal points p +- W +- 1, one ring out like the
// axis terms. Under no-flux walls the wrapped values meet zero aE/aN and
// the zeroed Dxy wall layers, so they contribute exact zeros.
template <int Kin, typename T, class Grid>
__device__ __forceinline__ void aniso_rhs(
    const TensorConstants<T>& c, const RhsConstants<T>& k, const Grid& grid,
    T fz, const T* su, const T* sv, int p, int W, int gy, int gx,
    T& du_out, T& dv_out) {
  const int rn = grid.north(gy), rs = grid.south(gy);
  const int ce = grid.east(gx), cw = grid.west(gx);
  const T u = su[p];
  const T ue = su[p + 1], uw = su[p - 1];
  const T un = su[p + W], us = su[p - W];
  const T axis = __ldg(c.aE + grid.field(gy, gx)) * (ue - u)
                 + __ldg(c.aE + grid.field(gy, cw)) * (uw - u)
                 + __ldg(c.aN + grid.field(gy, gx)) * (un - u)
                 + __ldg(c.aN + grid.field(rs, gx)) * (us - u);
  const T fx_e = __ldg(c.dxyw + grid.field(gy, ce))
                 * (su[p + W + 1] - su[p - W + 1]);
  const T fx_w = __ldg(c.dxyw + grid.field(gy, cw))
                 * (su[p + W - 1] - su[p - W - 1]);
  const T fy_n = __ldg(c.dxyw + grid.field(rn, gx))
                 * (su[p + W + 1] - su[p + W - 1]);
  const T fy_s = __ldg(c.dxyw + grid.field(rs, gx))
                 * (su[p - W + 1] - su[p - W - 1]);
  const T lap = axis + ((fx_e - fx_w) + (fy_n - fy_s));
  T du, dv;
  kinetics<Kin>(u, sv[p], beta_at(k, gy), du, dv);
  du = du + lap;
  if (k.has_freeze) {
    const T live = live_at(k, fz, gy);
    du = du * live;
    dv = dv * live;
  }
  du_out = du;
  dv_out = dv;
}

// aniso_rhs on a point's coefficients read before (FacePoint: aE, aW, aN,
// aS, beta and live; x unused) and dxyw in a plane sx of the region's
// layout, the same operations in the same order: K5's association axis +
// ((fx_e - fx_w) + (fy_n - fy_s)) on the folded dxyw, not K11's
// (mixed_point_rhs)
template <int Kin, typename T>
__device__ __forceinline__ void aniso_point_rhs(
    const FacePoint<T>& c, bool freeze, const T* sx, const T* su, T v,
    int p, int W, T& du_out, T& dv_out) {
  const T u = su[p];
  const T axis = c.ae * (su[p + 1] - u) + c.aw * (su[p - 1] - u)
                 + c.an * (su[p + W] - u) + c.as * (su[p - W] - u);
  const T fx_e = sx[p + 1] * (su[p + W + 1] - su[p - W + 1]);
  const T fx_w = sx[p - 1] * (su[p + W - 1] - su[p - W - 1]);
  const T fy_n = sx[p + W] * (su[p + W + 1] - su[p + W - 1]);
  const T fy_s = sx[p - W] * (su[p - W + 1] - su[p - W - 1]);
  const T lap = axis + ((fx_e - fx_w) + (fy_n - fy_s));
  T du, dv;
  kinetics<Kin>(u, v, c.beta, du, dv);
  du = du + lap;
  if (freeze) {
    du = du * c.live;
    dv = dv * c.live;
  }
  du_out = du;
  dv_out = dv;
}

// aniso_rhs as the functor the ERK tile kernels take (K5, WrapGrid;
// erk_tile.cuh, erk_slots.cuh); point() reads aE and aN at the point, aW
// as aE at the west neighbour's column and aS as aN at the row below (gs),
// once; plane(0, g) is dxyw at field offset g, which the mixed fluxes read
// at the four neighbours, for a shared plane; at_point() evaluates on them
template <int Kin, typename T, class Grid>
struct AnisoRhs {
  static constexpr int kPlanes = 1;
  using Point = FacePoint<T>;

  TensorConstants<T> c;
  RhsConstants<T> k;
  Grid grid;

  __device__ __forceinline__ void operator()(T fz, const T* su, const T* sv,
                                             int p, int W, int gy, int gx,
                                             T& du, T& dv) const {
    aniso_rhs<Kin>(c, k, grid, fz, su, sv, p, W, gy, gx, du, dv);
  }
  __device__ __forceinline__ FacePoint<T> point(T fz, size_t g, size_t gs,
                                                int r, int col) const {
    return {__ldg(c.aE + g),
            __ldg(c.aE + grid.field(r, grid.west(col))),
            __ldg(c.aN + g),
            __ldg(c.aN + gs),
            T(1),
            beta_at(k, r),
            k.has_freeze ? live_at(k, fz, r) : T(1)};
  }
  __device__ __forceinline__ T plane(int, size_t g) const {
    return __ldg(c.dxyw + g);
  }
  __device__ __forceinline__ void at_point(const FacePoint<T>& cf,
                                           const T* sx, const T* su, T v,
                                           int p, int W, T& du,
                                           T& dv) const {
    aniso_point_rhs<Kin>(cf, k.has_freeze, sx, su, v, p, W, du, dv);
  }
};

// One partial sum per block in a fixed order (warp shuffles, then warp 0's
// sums in order): no float atomics, so two launches agree bitwise.
template <typename T, int kThreads>
__device__ __forceinline__ void store_block_sum(T acc, T* warp_sums,
                                                T* out) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    out[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

}  // namespace crd
