// Fused RKC2 step of the 5-point profile operator or of the divergence-form
// (face-coefficient) operator, with FitzHugh-Nagumo, Goldbeter or
// Aliev-Panfilov kinetics (kernel K2 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_rkc.py::build_fused_rkc_step, the Pallas
// TPU kernel that takes every attempted step of an rkc2 run on a large
// grid, both its profile and its divform branch, and ::_build_blocked
// (K2b), the same step laid out in column blocks so that a TPU row strip
// fits its VMEM at very wide rows: the tiles here do not depend on the row
// width, so this kernel at those shapes is K2b's step, without the blocks
// and their halo refresh. One launch performs a whole step of s Chebyshev
// stages (integrate/rkc.py): F0 = f(y0), Y1 = y0 + (h mu1) F0, for
// j = 2..s
//   Yj = (1 - mu - nu) y0 + mu Yj-1 + nu Yj-2 + (h mut) f(Yj-1) + (h gt) F0,
// y_new = Ys, F1 = f(y_new), the order-2 error estimate
// est = 0.8 (y0 - y_new) + (0.4 h)(F0 + F1), and one partial sum of squared
// WRMS-scaled errors per 32x32 tile (summed by the caller; no float
// atomics, so two launches on the same input give bitwise-equal results),
// each added in the order of the one-pass tile kernel this step first ran
// on, at these tiles (rkc_chunk.cuh), so that a run's error sums, and with
// them its accepted and rejected steps, are those of that kernel: rkc2's
// f32 error estimate sits at the rounding floor between waves, where the
// order of a sum decides steps.
//
// The stage count s, h, the freeze scalar and the coefficient tables live
// on the device: the kernel reads s and indexes mu1[s] and ctab[s][j]
// itself, so the host never learns s. An s outside [2, s_cap] is refused
// by NaN partial sums, which the adaptive loop rejects.
//
// What bounds it on an H100: the state (2 x ny x nx) is read once and
// y_new written once (about 10 MB a step on 400x1600 in f32, 655 MB on
// 12800x3200), whatever s; the divergence form adds its face fields (aE,
// aW, aN, the tissue field: 10.2 MB at 1600x400 in f32). The work is
// s + 1 right-hand sides a point, and at s = 23 the operations bound it.
//
// Design: rkc_chunk.cuh's chunked tile scheme with the WrapGrid policy
// (K9, fused_shard_rkc.cu, is the same kernel on a shard's halo): the
// s + 1 RHS evaluations in chunks of at most 6, each a pass over 32x32
// tiles whose regions carry a halo as deep as the chunk, the live pair and
// F0 handed on through device memory at a grid barrier, in one persistent
// cooperative launch; a point's recurrence values in its thread's
// registers. One partial sum a 32x32 tile, in the one-pass tile kernel's
// order. The right-hand side at a point is ProfileRhs, or DivformRhs
// (K4's operator, whose face coefficients are read through the read-only
// data cache), each over the kinetics family. No tensor cores, TMA or
// tuning yet.
//
// A structured forcing (pallas_rkc.py:434-468, 517-551, 715-735) comes in
// as an amplitude table amps[n_stim][n_cols] computed on the device before
// the launch and the stimuli's row and column profiles: n_cols = 1 when
// every stimulus is segment-gated (a pulse train: the amplitude is
// constant over the step), else one column per stage time of the JAX
// package's with_times table (S_MAX_KERNEL + 2), the Chebyshev stage
// times of this step's s, indexed by the step's evaluation, not by its
// place in its chunk (rhs_common.cuh::rkc_amp_column). Evaluation e adds
// (amps[j][a] * rows[j][r]) * cols[j][c] before the live factor and the
// tissue field, in both branches. The JAX package declines forcing on
// its column-blocked K2b layout (pallas_rkc.py:230-234); this kernel has
// no column blocks and takes it at every width. n_stim = 0 takes the
// unforced instantiation.

#include <cuda_runtime.h>

#include <type_traits>

#include "rhs_common.cuh"
#include "rkc_chunk.cuh"

namespace {

using crd::WrapGrid;

// go(rhs) for the kinetics id: DivformRhs when the face field aE is given,
// else ProfileRhs.
template <typename T, class F>
int dispatch(const crd::RhsConstants<T>& k, const crd::FaceConstants<T>& f,
             const WrapGrid& wg, int kinetics, F go) {
  return crd::with_kinetics(kinetics, [&](auto kin) {
    constexpr int Kin = decltype(kin)::value;
    if (f.aE != nullptr)
      return go(crd::DivformRhs<Kin, T, WrapGrid>{f, k, wg});
    return go(crd::ProfileRhs<Kin, T>{k});
  });
}

// amps, rows, cols, n_stim, n_cols, var1: the structured forcing
// (n_stim = 0 and null pointers without one)
template <typename T>
int launch(const void* y, void* y_new, void* ss, void* work, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* s, const void* mu1_tab,
           const void* ctab, int s_cap, const void* c0, const void* c1,
           const void* c2, int torus, const void* ae, const void* aw,
           const void* an, const void* tissue, const void* beta,
           int beta_field, const void* mask, int has_freeze, int kinetics,
           int ny, int nx, double rtol, double atol, void* stream) {
  if (s_cap < 2 || s_cap > crd::kRkcMaxStages || ny < 1 || nx < 1
      || !crd::valid_kinetics(kinetics)
      || (ae == nullptr) == (c0 == nullptr)
      || (ae != nullptr && (aw == nullptr || an == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const crd::FaceConstants<T> f = {
      static_cast<const T*>(ae), static_cast<const T*>(aw),
      static_cast<const T*>(an), static_cast<const T*>(tissue)};
  const WrapGrid wg{ny, nx};
  const int tiles_x = (nx + crd::kRkcTile - 1) / crd::kRkcTile;
  const int n_tiles = tiles_x * ((ny + crd::kRkcTile - 1) / crd::kRkcTile);
  const crd::RkcPlan plan = {ny,      nx,      crd::kRkcTile, crd::kRkcTile,
                             tiles_x, n_tiles};
  return crd::with_stim<T>(
      amps, rows, cols, n_stim, n_cols, var1,
      n_cols == 1 || n_cols == crd::kRkcMaxStages + 2, ny, nx,
      [&](auto stim) {
        return dispatch<T>(k, f, wg, kinetics, [&](auto rhs) {
          return crd::launch_rkc_chunk<decltype(rhs), WrapGrid, T>(
              rhs, wg, plan, n_tiles, y, y_new, ss, work, h, fz, s, mu1_tab,
              ctab, s_cap, rtol, atol, stream, stim);
        });
      });
}

// out[0] the resident blocks an SM, out[1] the registers a thread, out[2]
// the shared bytes (dynamic and static) a block of the profile (divform =
// 0) or divergence-form kernel of `kinetics` in T; returns the CUDA error
// code.
template <typename T>
int info(int divform, int kinetics, int* out) {
  if (!crd::valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  crd::FaceConstants<T> f = {};
  const T dummy = T(0);
  if (divform) f.aE = &dummy;         // selects DivformRhs; never read
  return dispatch<T>(crd::RhsConstants<T>{}, f, WrapGrid{1, 1}, kinetics,
                     [&](auto rhs) {
    return crd::rkc_chunk_info<decltype(rhs), WrapGrid, T>(out);
  });
}

}  // namespace

// amps, rows, cols, n_stim, n_cols and var1: the structured forcing; c0,
// c1, c2 and torus: the profile operator (null without it); ae, aw, an
// and tissue: the divergence form's face fields and the 0/1 tissue field
// (all null without it; tissue null without an obstacle); work: ten planes
// of the state's shape
#define CRD_FUSED_RKC_ARGS                                                   \
  const void *y, void *y_new, void *ss, void *work, const void *h,           \
      const void *fz, const void *amps, const void *rows, const void *cols,  \
      int n_stim, int n_cols, int var1, const void *s, const void *mu1_tab,  \
      const void *ctab, int s_cap, const void *c0, const void *c1,           \
      const void *c2, int torus, const void *ae, const void *aw,             \
      const void *an, const void *tissue, const void *beta, int beta_field,  \
      const void *mask, int has_freeze, int kinetics, int ny, int nx,        \
      double rtol, double atol, void *stream
#define CRD_FUSED_RKC_PASS                                                   \
  y, y_new, ss, work, h, fz, amps, rows, cols, n_stim, n_cols, var1, s,      \
      mu1_tab, ctab, s_cap, c0, c1, c2, torus, ae, aw, an, tissue, beta,     \
      beta_field, mask, has_freeze, kinetics, ny, nx, rtol, atol, stream

extern "C" int crd_fused_rkc_step_f32(CRD_FUSED_RKC_ARGS) {
  return launch<float>(CRD_FUSED_RKC_PASS);
}

extern "C" int crd_fused_rkc_step_f64(CRD_FUSED_RKC_ARGS) {
  return launch<double>(CRD_FUSED_RKC_PASS);
}

extern "C" int crd_fused_rkc_info(int f64, int divform, int kinetics,
                                  int* out) {
  return f64 ? info<double>(divform, kinetics, out)
             : info<float>(divform, kinetics, out);
}
