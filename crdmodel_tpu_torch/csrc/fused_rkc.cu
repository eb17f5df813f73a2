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
// stages
// (integrate/rkc.py): F0 = f(y0), Y1 = y0 + (h mu1) F0, for j = 2..s
//   Yj = (1 - mu - nu) y0 + mu Yj-1 + nu Yj-2 + (h mut) f(Yj-1) + (h gt) F0,
// y_new = Ys, F1 = f(y_new), the order-2 error estimate
// est = 0.8 (y0 - y_new) + (0.4 h)(F0 + F1), and one partial sum of squared
// WRMS-scaled errors per thread block (summed by the caller; no float
// atomics, so two launches on the same input give bitwise-equal results).
//
// The stage count s, h, the freeze scalar and the coefficient tables live
// on the device: the kernel reads s and indexes mu1[s] and ctab[s][j]
// itself, so the host never learns s. An s outside [2, s_cap] is refused
// by NaN partial sums, which the adaptive loop rejects.
//
// What bounds it on an H100: the state (2 x ny x nx) is read once and
// y_new written once (about 10 MB a step on 400x1600 in f32, 655 MB on
// 12800x3200), whatever s; the divergence form adds its face fields (aE,
// aW, aN, the tissue field: 10.2 MB at 1600x400 in f32).
// The work is s + 2 right-hand sides a point, on a region that carries a
// halo of s + 1 rings: at s = 23 a 32x32 tile computes about 3.1x its own
// points on average over the evaluations, at s = 5 about 1.35x. The block's
// barriers between stages and the shared-memory traffic bound a step long
// before device memory does.
//
// Design (the tile scheme of rkc_tile.cuh, on the periodic grid): each
// block owns a tile_y x tile_x tile and loads it with a halo of s + 1
// rings by modular index (the periodic wrap, any number of times on grids
// smaller than the halo). The three-term recurrence has a live set
// of constant size, kept in shared memory: y0, F0, Yj-1 and Yj-2, two
// variables each. Yj overwrites Yj-2 in place (it reads Yj-2 only at its
// own point), so four buffers carry any s. Stage j is evaluated on the
// points at depth >= j, and F1 on the tile. Shared memory is sized for
// s_cap + 1 rings when the launch is configured, before s is known; a
// smaller s packs its smaller region into the same space. The arithmetic
// follows the plain version (ops/fused_rkc.py::fused_rkc_step_reference)
// operation for operation, and the library is built with -fmad=false. The
// right-hand side at a point is a functor the kernel template takes, as in
// erk_tile.cuh: ProfileRhs, or DivformRhs (K4's operator, whose face
// coefficients are read through the read-only data cache, no new shared
// arrays), each over the kinetics family. No tensor cores, TMA or tuning
// yet.

#include <cuda_runtime.h>

#include "rhs_common.cuh"
#include "rkc_tile.cuh"

namespace {

// The kernel for the kinetics id `kinetics`: DivformRhs when the face
// field aE is given, else ProfileRhs.
template <int Kin, typename T>
int launch_kinetics(const crd::RhsConstants<T>& k,
                    const crd::FaceConstants<T>& f, const void* y,
                    void* y_new, void* ss, const void* h, const void* fz,
                    const void* s, const void* mu1_tab, const void* ctab,
                    int s_cap, int ny, int nx, int tile_x, int tile_y,
                    double rtol, double atol, void* stream) {
  if (f.aE != nullptr)
    return crd::launch_rkc_tile<crd::DivformRhs<Kin, T, crd::WrapGrid>,
                                 crd::WrapGrid, T>(
        {f, k, {ny, nx}}, {ny, nx}, y, y_new, ss, h, fz, s, mu1_tab, ctab,
        s_cap, ny, nx, tile_x, tile_y, rtol, atol, stream);
  return crd::launch_rkc_tile<crd::ProfileRhs<Kin, T>, crd::WrapGrid, T>(
      {k}, {ny, nx}, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, ny, nx,
      tile_x, tile_y, rtol, atol, stream);
}

template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* s, const void* mu1_tab,
           const void* ctab, int s_cap, const void* c0, const void* c1,
           const void* c2, int torus, const void* ae, const void* aw,
           const void* an, const void* tissue, const void* beta,
           int beta_field, const void* mask, int has_freeze, int kinetics,
           int ny, int nx, int tile_x, int tile_y, double rtol, double atol,
           void* stream) {
  if (s_cap < 2 || s_cap > crd::kRkcMaxStages || ny < 1 || nx < 1 || tile_x < 1
      || tile_y < 1 || !crd::valid_kinetics(kinetics)
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
  if (kinetics == crd::kFhn)
    return launch_kinetics<crd::kFhn, T>(k, f, y, y_new, ss, h, fz, s,
                                         mu1_tab, ctab, s_cap, ny, nx,
                                         tile_x, tile_y, rtol, atol, stream);
  if (kinetics == crd::kGoldbeter)
    return launch_kinetics<crd::kGoldbeter, T>(
        k, f, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, ny, nx, tile_x,
        tile_y, rtol, atol, stream);
  return launch_kinetics<crd::kAlievPanfilov, T>(
      k, f, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, ny, nx, tile_x,
      tile_y, rtol, atol, stream);
}

}  // namespace

// c0, c1, c2 and torus: the profile operator (null without it); ae, aw, an
// and tissue: the divergence form's face fields and the 0/1 tissue field
// (all null without it; tissue null without an obstacle)
#define CRD_FUSED_RKC_ARGS                                                   \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,      \
      const void *s, const void *mu1_tab, const void *ctab, int s_cap,      \
      const void *c0, const void *c1, const void *c2, int torus,            \
      const void *ae, const void *aw, const void *an, const void *tissue,   \
      const void *beta, int beta_field, const void *mask, int has_freeze,   \
      int kinetics, int ny, int nx, int tile_x, int tile_y, double rtol,    \
      double atol, void *stream
#define CRD_FUSED_RKC_PASS                                                   \
  y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, c0, c1, c2, torus, ae, aw,  \
      an, tissue, beta, beta_field, mask, has_freeze, kinetics, ny, nx,     \
      tile_x, tile_y, rtol, atol, stream

extern "C" int crd_fused_rkc_step_f32(CRD_FUSED_RKC_ARGS) {
  return launch<float>(CRD_FUSED_RKC_PASS);
}

extern "C" int crd_fused_rkc_step_f64(CRD_FUSED_RKC_ARGS) {
  return launch<double>(CRD_FUSED_RKC_PASS);
}
