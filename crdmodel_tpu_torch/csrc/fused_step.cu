// Fused embedded-ERK step of the 5-point profile operator with
// FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov kinetics (kernel K1 of the
// port).
//
// Replaces crdmodel_tpu/ops/pallas_step.py::build_fused_step, the Pallas TPU
// kernel that takes every attempted step of the canonical FHN and Goldbeter
// torus runs with their own method, bs32.
// One launch performs a whole step: every stage's stencil and kinetics, the
// solution update, and one partial sum of squared WRMS-scaled errors per
// thread block (the tile scheme of erk_tile.cuh).
//
// What bounds it on an H100: the state (2 x ny x nx) is read once and
// y_new written once (about 10 MB a bs32 step on 400x1600 in f32), and the
// stage arithmetic is a few dozen flops a point. Neither bandwidth nor
// flops is near its limit; a step is bound by latency: the block's
// barriers between stages, the shared-memory traffic of the stage
// buffers, and the host's launches around the kernel.
//
// The RHS at a point is the shared functor crd::ProfileRhs of
// rhs_common.cuh, with the kinetics family a template parameter (one
// instance per family). No tensor cores, TMA or tuning yet.

#include <cuda_runtime.h>

#include "erk_tile.cuh"
#include "rhs_common.cuh"

namespace {

using crd::ProfileRhs;

template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* c0, const void* c1, const void* c2,
           int torus, const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int ny, int nx, int tile_x,
           int tile_y, int n_stages, const double* a, const double* b,
           const double* d, double rtol, double atol, void* stream) {
  crd::StageTable tab;
  if (!crd::make_stage_table(n_stages, a, b, d, &tab)
      || !crd::valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  if (kinetics == crd::kFhn)
    return crd::launch_erk_tile<ProfileRhs<crd::kFhn, T>, T>(
        {k}, y, y_new, ss, h, fz, ny, nx, tile_x, tile_y, tab, rtol, atol,
        stream);
  if (kinetics == crd::kGoldbeter)
    return crd::launch_erk_tile<ProfileRhs<crd::kGoldbeter, T>, T>(
        {k}, y, y_new, ss, h, fz, ny, nx, tile_x, tile_y, tab, rtol, atol,
        stream);
  return crd::launch_erk_tile<ProfileRhs<crd::kAlievPanfilov, T>, T>(
      {k}, y, y_new, ss, h, fz, ny, nx, tile_x, tile_y, tab, rtol, atol,
      stream);
}

}  // namespace

#define CRD_FUSED_STEP_ARGS                                                  \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,      \
      const void *c0, const void *c1, const void *c2, int torus,            \
      const void *beta, int beta_field, const void *mask, int has_freeze,   \
      int kinetics, int ny, int nx, int tile_x, int tile_y, int n_stages,   \
      const double *a, const double *b, const double *d, double rtol,       \
      double atol, void *stream
#define CRD_FUSED_STEP_PASS                                                  \
  y, y_new, ss, h, fz, c0, c1, c2, torus, beta, beta_field, mask,           \
      has_freeze, kinetics, ny, nx, tile_x, tile_y, n_stages, a, b, d,      \
      rtol, atol, stream

extern "C" int crd_fused_erk_step_f32(CRD_FUSED_STEP_ARGS) {
  return launch<float>(CRD_FUSED_STEP_PASS);
}

extern "C" int crd_fused_erk_step_f64(CRD_FUSED_STEP_ARGS) {
  return launch<double>(CRD_FUSED_STEP_PASS);
}
