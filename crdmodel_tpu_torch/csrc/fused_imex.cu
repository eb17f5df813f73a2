// Fused IMEX ARK3(2)4L[2]SA step of the 5-point profile operator (explicit)
// and pointwise FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov kinetics
// (implicit), kernel K3 of the port.
//
// Replaces crdmodel_tpu/ops/pallas_imex.py::build_fused_imex_step, the
// Pallas TPU kernel that takes every attempted step of an ark324 run on the
// fused path. One launch performs a whole additive Runge-Kutta step
// (integrate/imex.py::make_imex_step_err): the 4 explicit stencil
// evaluations kE_i = f_ex(Y_i); the 3 implicit stages, each solving
// Y = rhs_known + (h gamma) f_im(Y) at every point by 3 full Newton
// iterations (closed-form 2x2 Jacobian, residual, Cramer solve); the stage
// slopes kI_i = (Y_i - rhs_known_i)/(h gamma); y_new = y0 + sum (h B_j)
// (kE_j + kI_j); err = sum (h D_j)(kE_j + kI_j); and one partial sum per
// thread block of sum (err w)^2 + (1/NEWTON_TOL)^2 sum_stages (dy w)^2,
// with w = 1/(rtol |y0| + atol) and dy each stage's last Newton update
// (summed by the caller; no float atomics, so two launches on the same
// input give bitwise-equal results).
//
// What bounds it on an H100: the state (2 x ny x nx) is read once and
// y_new written once (about 41 MB a step on 800x3200 in f32, some 12 us at
// the published 3.35 TB/s). The work is the Newton: 9 iterations a point,
// each a Jacobian, a kinetics evaluation and a solve, with about 8 IEEE
// divisions for Goldbeter, some 500 flops and 70 divisions a point, on
// 1.27x the tile's points (the Newton's rings). So the step is bound by
// arithmetic, divisions first, and at small grids by how few blocks there
// are to spread it over.
//
// Design: imex_slots.cuh's register-resident scheme with the WrapGrid
// policy (tile_slots.cuh::SlotOrigin<WrapGrid>): 512 threads fixed to a
// tile's points and its Newton rings, the pointwise state in registers, y0's
// u and the stage value of variable 0 in three shared planes of the
// region; a tile whose 4-ring region lies inside the grid takes code
// without the wrap, the others wrap by loops (as often as a grid narrower
// than the region needs). The plan is sized to the grid
// (ops/fused_imex.py::slots_plan): 32x32 tiles, or 32x16 ones (one tile
// point and at most one ring point a thread) where 32x32 tiles would
// number fewer than the card's SMs; the caller passes the plan's tile.
// y_new is bitwise the plain version's (ops/fused_imex.py::
// imex_stages_reference), and each partial sum adds its tile's terms in
// the order of K3's first port, a 256-thread one-pass block on the same
// tile (ops/fused_imex.py::imex_tile_sums), so a run at the 32x32 plan
// takes that kernel's steps exactly.
//
// A structured forcing (pallas_imex.py:190-217, 232-240, 312) comes in as
// an amplitude table amps[n_stim][4], the explicit stages' amplitudes at
// the ARK c nodes computed on the device before the launch, and the
// stimuli's profiles; it joins the explicit evaluations only
// (imex_slots.cuh), so the Newton stages stay autonomous. n_stim = 0 takes
// the unforced instantiation.

#include <cuda_runtime.h>

#include "imex_slots.cuh"
#include "rhs_common.cuh"

namespace {

// the launch on the plan's 32 x tile_y tiles
template <typename T, class Stim>
int launch_plan(const crd::WrapGrid& grid, const void* y, void* y_new,
                void* ss, const void* h, const void* fz,
                const crd::RhsConstants<T>& k, int kinetics, int ny, int nx,
                int tile_y, const crd::ImexTable& tab, double rtol,
                double atol, void* stream, Stim stim) {
  if (tile_y == 32)
    return crd::launch_imex_slots<crd::WrapGrid, T, 32>(
        grid, y, y_new, ss, h, fz, k, kinetics, ny, nx, tab, rtol, atol,
        stream, stim);
  if (tile_y == 16)
    return crd::launch_imex_slots<crd::WrapGrid, T, 16>(
        grid, y, y_new, ss, h, fz, k, kinetics, ny, nx, tab, rtol, atol,
        stream, stim);
  return static_cast<int>(cudaErrorInvalidValue);
}

// amps, rows, cols, n_stim, n_cols, var1: the structured forcing of the
// explicit stages (n_stim = 0 and null pointers without one)
template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* c0, const void* c1, const void* c2,
           int torus, const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int ny, int nx, int tile_x,
           int tile_y, const double* ae, const double* ai, const double* b,
           const double* d, double gamma, double rtol, double atol,
           void* stream) {
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const crd::WrapGrid grid = {ny, nx};
  const crd::ImexTable tab = crd::make_imex_table(ae, ai, b, d, gamma);
  if (tile_x != crd::kImexTile)
    return static_cast<int>(cudaErrorInvalidValue);
  return crd::with_stim<T>(
      amps, rows, cols, n_stim, n_cols, var1, n_cols == crd::kImexStages,
      ny, nx, [&](auto stim) {
        return launch_plan<T>(grid, y, y_new, ss, h, fz, k, kinetics, ny,
                              nx, tile_y, tab, rtol, atol, stream, stim);
      });
}

// crd::imex_slots_info of the kernel of `kinetics` on 32 x tile_y tiles
template <typename T>
int info(int kinetics, int tile_y, int* out) {
  if (tile_y == 32)
    return crd::imex_slots_info<crd::WrapGrid, T, 32>(kinetics, out);
  if (tile_y == 16)
    return crd::imex_slots_info<crd::WrapGrid, T, 16>(kinetics, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define CRD_FUSED_IMEX_ARGS                                                  \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,       \
      const void *amps, const void *rows, const void *cols, int n_stim,      \
      int n_cols, int var1, const void *c0, const void *c1,                  \
      const void *c2, int torus, const void *beta, int beta_field,           \
      const void *mask, int has_freeze, int kinetics, int ny, int nx,        \
      int tile_x, int tile_y, const double *ae, const double *ai,            \
      const double *b, const double *d, double gamma, double rtol,           \
      double atol, void *stream
#define CRD_FUSED_IMEX_PASS                                                  \
  y, y_new, ss, h, fz, amps, rows, cols, n_stim, n_cols, var1, c0, c1,       \
      c2, torus, beta, beta_field, mask, has_freeze, kinetics, ny, nx,       \
      tile_x, tile_y, ae, ai, b, d, gamma, rtol, atol, stream

extern "C" int crd_fused_imex_step_f32(CRD_FUSED_IMEX_ARGS) {
  return launch<float>(CRD_FUSED_IMEX_PASS);
}

extern "C" int crd_fused_imex_step_f64(CRD_FUSED_IMEX_ARGS) {
  return launch<double>(CRD_FUSED_IMEX_PASS);
}

extern "C" int crd_fused_imex_info(int f64, int kinetics, int tile_y,
                                   int* out) {
  return f64 ? info<double>(kinetics, tile_y, out)
             : info<float>(kinetics, tile_y, out);
}
