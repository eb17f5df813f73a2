// Fused embedded-ERK step of the divergence-form operator, or of the 2-D
// tensor operator, with FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov
// kinetics on one shard of a 2-D mesh (kernel K11 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_shard_divform.py::
// build_fused_shard_divform, the Pallas TPU kernel that takes every
// attempted step of a sharded ERK run of bounded tissue (no-flux walls,
// obstacle scars, 2-D and flat diffusion fields) and, in its aniso mode, of
// a 2-D diffusion tensor on the flat surface or the torus. It is K4
// (fused_divform.cu) on one shard: one exchange of width P >= n_stages a
// step (parallel/halo.py::refresh_halos) fills the halo of the shard's
// buffer, and one launch computes every stage, the solution update, and one
// partial sum of squared WRMS-scaled errors per thread block over the
// PHYSICAL cells. The caller adds every shard's partials in a fixed order.
//
// The tile scheme is erk_slots.cuh's with the HaloGrid policy
// (rhs_common.cuh) for bs32, the main path's tableau, and K1's
// (erk_tile.cuh) for zonneveld43 and dopri54, by the launcher's dispatch
// on the stage count (launch_erk_slots_on). The RHS is one of two
// functors over the shard's halo-padded coefficient stack
// (ops/kernel_common.py::make_shard_divform_constants), built and
// exchanged once a run:
//   mode 0, DivformRhs: K4's face operator, aE, aW, aN and aS = aN of the
//     row below, with the 0/1 tissue field of an obstacle as the fourth
//     plane (obstacle cells get ydot = 0 and hold their IC bitwise);
//   mode 1, MixedDivformRhs: the same axis terms plus the mixed pair on the
//     raw Dxy (the fourth plane), axis + inv4 (t1 + t2), the XLA path's
//     association, with inv4 a scalar (flat) or the halo-padded column
//     profile (torus). K5's AnisoRhs folds Dxy inv4 and adds axis +
//     (t1 + t2): the two round differently.
// Closed faces carry zero coefficients, so the halo values they meet add
// exact zeros. On a mesh that does not divide the grid the kernel runs the
// JAX kernels' mirror-pad semantics, as K8 does. Only the block of y_new is
// written; its halo is the next exchange's.
//
// What bounds it on an H100: the shard's buffer and its 3-4 coefficient
// planes are read once and y_new's block written once, as for K4: a step
// is bound by latency and issue, and by the host's launches and halo
// copies around it. The design is K4's: 512 threads fixed to a tile and
// its n - 1 rings, the stage inputs, error and coefficients of a point in
// its thread's registers (the coefficients read once a launch:
// DivformRhs::point, MixedDivformRhs::point), the stage input's variable 0
// and, in aniso mode, Dxy (read at neighbours) in shared planes. The
// exchange filled HALO >= n rings, so a full tile's region never clamps;
// only the partial tiles at the block's last rows and columns take the
// clamped code. Each partial sum adds its tile's points in erk_tile.cuh's
// order: y_new's block and every partial sum are bitwise those of the
// plain version and of erk_tile.cuh's scheme.
//
// A structured forcing (pallas_shard_divform.py:99-101, 204-211, 263-271,
// 343-352, 444-467), in both modes, comes in as K4's (fused_divform.cu): an
// amplitude table amps[n_stim][n_stages] computed on the device before
// the launch, and each stimulus's row and column profiles halo-padded to
// the shard's buffer (ops/kernel_common.py::prepare_shard_stim_constants);
// stage s adds (amps[j][s] * rows[j][r]) * cols[j][c] at the buffer's
// (r, c) its state comes from, before the live factor and the tissue
// field (rhs_common.cuh::StimTable, add_operator). A cell outside the
// no-flux walls meets zero faces but still reads its profile at its
// source index. n_stim = 0 takes the unforced instantiation (NoStim).

#include <cuda_runtime.h>

#include "erk_slots.cuh"
#include "rhs_common.cuh"

namespace {

using crd::HaloGrid;

template <int Kin, typename T, class Stim>
int launch_kinetics(const crd::FaceConstants<T>& f,
                    const crd::MixedConstants<T>& m,
                    const crd::RhsConstants<T>& k, int mode,
                    const HaloGrid& grid, const void* y, void* y_new,
                    void* ss, const void* h, const void* fz, int tile_x,
                    int tile_y, const crd::StageTable& tab, double rtol,
                    double atol, void* stream, Stim stim) {
  if (mode == 1)
    return crd::launch_erk_slots_on<crd::MixedDivformRhs<Kin, T, HaloGrid>,
                                    T>(
        {f, m, k, grid}, grid, y, y_new, ss, h, fz, grid.nyl, grid.nxl,
        tile_x, tile_y, tab, rtol, atol, stream, stim);
  return crd::launch_erk_slots_on<crd::DivformRhs<Kin, T, HaloGrid>, T>(
      {f, k, grid}, grid, y, y_new, ss, h, fz, grid.nyl, grid.nxl, tile_x,
      tile_y, tab, rtol, atol, stream, stim);
}

// crd::slots_kernel_info of the bs32 kernel of (mode, kinetics) in T
template <int Kin, typename T>
int info_kinetics(int mode, int* out) {
  if (mode == 1)
    return crd::slots_kernel_info<crd::MixedDivformRhs<Kin, T, HaloGrid>,
                                  HaloGrid, T>(out);
  return crd::slots_kernel_info<crd::DivformRhs<Kin, T, HaloGrid>, HaloGrid,
                                T>(out);
}

template <typename T>
int info(int mode, int kinetics, int* out) {
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kinetics == crd::kFhn) return info_kinetics<crd::kFhn, T>(mode, out);
  if (kinetics == crd::kGoldbeter)
    return info_kinetics<crd::kGoldbeter, T>(mode, out);
  if (kinetics == crd::kAlievPanfilov)
    return info_kinetics<crd::kAlievPanfilov, T>(mode, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// amps, rows, cols, n_stim, n_cols, var1: the structured forcing, its
// profiles halo-padded to the buffer (n_stim = 0 and null pointers
// without one)
template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* ae, const void* aw, const void* an,
           const void* fourth, int mode, const void* inv4, int inv4_profile,
           const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int nyl, int nxl, int halo,
           int valid_rows, int valid_cols, int tile_x, int tile_y,
           int n_stages, const double* a, const double* b, const double* d,
           double rtol, double atol, void* stream) {
  crd::StageTable tab;
  if (!crd::make_stage_table(n_stages, a, b, d, &tab)
      || !crd::valid_kinetics(kinetics) || halo < n_stages
      || valid_rows < 0 || valid_rows > nyl || valid_cols < 0
      || valid_cols > nxl || (mode != 0 && mode != 1)
      || (mode == 1 && (fourth == nullptr || inv4 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::FaceConstants<T> f = {
      static_cast<const T*>(ae), static_cast<const T*>(aw),
      static_cast<const T*>(an),
      mode == 0 ? static_cast<const T*>(fourth) : nullptr};
  const crd::MixedConstants<T> m = {
      mode == 1 ? static_cast<const T*>(fourth) : nullptr,
      static_cast<const T*>(inv4), inv4_profile};
  const crd::RhsConstants<T> k = {
      nullptr, nullptr, nullptr, 0, static_cast<const T*>(beta), beta_field,
      static_cast<const T*>(mask), has_freeze};
  const HaloGrid grid = {nyl, nxl, halo, valid_rows, valid_cols};
  return crd::with_stim<T>(
      amps, rows, cols, n_stim, n_cols, var1, n_cols == n_stages,
      nyl + 2 * halo, nxl + 2 * halo, [&](auto stim) {
        return crd::with_kinetics(kinetics, [&](auto kin) {
          return launch_kinetics<decltype(kin)::value, T>(
              f, m, k, mode, grid, y, y_new, ss, h, fz, tile_x, tile_y, tab,
              rtol, atol, stream, stim);
        });
      });
}

}  // namespace

// amps, rows, cols, n_stim, n_cols, var1: the structured forcing; fourth:
// the tissue field (mode 0, null without an obstacle) or Dxy (mode 1);
// inv4: the mixed pair's weight, a scalar or, with inv4_profile, the
// (nxl + 2 halo) column profile (mode 1; null in mode 0)
#define CRD_FUSED_SHARD_DIVFORM_ARGS                                         \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,       \
      const void *amps, const void *rows, const void *cols, int n_stim,      \
      int n_cols, int var1, const void *ae, const void *aw,                  \
      const void *an, const void *fourth, int mode,                          \
      const void *inv4, int inv4_profile, const void *beta,                  \
      int beta_field, const void *mask, int has_freeze, int kinetics,        \
      int nyl, int nxl, int halo, int valid_rows, int valid_cols,            \
      int tile_x, int tile_y, int n_stages, const double *a,                 \
      const double *b, const double *d, double rtol, double atol,            \
      void *stream
#define CRD_FUSED_SHARD_DIVFORM_PASS                                         \
  y, y_new, ss, h, fz, amps, rows, cols, n_stim, n_cols, var1, ae, aw, an,   \
      fourth, mode, inv4, inv4_profile, beta,                                \
      beta_field, mask, has_freeze, kinetics, nyl, nxl, halo, valid_rows,    \
      valid_cols, tile_x, tile_y, n_stages, a, b, d, rtol, atol, stream

extern "C" int crd_fused_shard_divform_step_f32(
    CRD_FUSED_SHARD_DIVFORM_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_DIVFORM_PASS);
}

extern "C" int crd_fused_shard_divform_step_f64(
    CRD_FUSED_SHARD_DIVFORM_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_DIVFORM_PASS);
}

extern "C" int crd_fused_shard_divform_info(int f64, int mode, int kinetics,
                                            int* out) {
  return f64 ? info<double>(mode, kinetics, out)
             : info<float>(mode, kinetics, out);
}
