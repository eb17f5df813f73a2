// Fused RKC2 step on the 3-D box, with FitzHugh-Nagumo, Goldbeter or
// Aliev-Panfilov kinetics, in the box operator's four modes (kernel K7 of
// the port).
//
// Replaces crdmodel_tpu/ops/pallas_box3d_rkc.py::build_fused_box3d_rkc_step,
// the Pallas TPU kernel that takes every attempted step of an rkc2 run on a
// box. A step of s Chebyshev stages (integrate/rkc.py): F0 = f(y0),
// Y1 = y0 + (h mu1) F0, for j = 2..s
//   Yj = (1 - mu - nu) y0 + mu Yj-1 + nu Yj-2 + (h mut) f(Yj-1) + (h gt) F0,
// y_new = Ys, F1 = f(y_new), est = 0.8 (y0 - y_new) + (0.4 h)(F0 + F1),
// and partial sums of squared WRMS-scaled errors in a fixed order
// (bitwise-equal across launches). s, h, the freeze scalar and
// the coefficient tables live on the device; an s outside [2, s_cap] keeps
// y and returns NaN partial sums, which the adaptive loop rejects.
//
// What bounds it on an H100: as K6, the state read once and y_new written
// once (134 MB at 32x512x512 in f32, some 40 us at 3.35 TB/s), plus each
// coefficient field once, whatever s; at s = 7 the arithmetic of s + 1
// right-hand sides a point comes close.
//
// Design: two schemes, chosen by the launcher on the operator mode
// (box_rkc_stream.cuh::rkc_stream_take), each the faster at the slab's
// shapes on the H100 (PERF.md, section 6). The tensor mode runs
// box_rkc_stream.cuh on the whole periodic box (StreamWrap): the s + 1
// evaluations in chunks of at most four, each chunk one z-streaming launch
// over 32 x 16 tiles and z chunks, the stage inputs' variable 0 in rings of
// three shared planes, the pointwise values with their points; the first
// chunk hands F0 and its last two stage values to the second through
// `work`: two launches a step at s >= 4, one partial sum a tile and z
// chunk. The profile, tissue and field modes run the persistent scheme:
// one cooperative launch, F0 and Y1 at every point, a grid barrier, then
// each stage's Yj at every point and a barrier, the recurrence's live set
// (F0, Yj-1, Yj-2; y0 is the input) in `work`'s three states; Yj
// overwrites Yj-2 in place (a point reads Yj-2 only at itself); some 4 + 5s
// state sweeps a step where the bound is 2, one partial sum a resident
// block. The TPU kernel's stage cap (ops/fused_box3d_rkc.py C_RKC = 7) is
// this kernel's too: two chunks of four. No tensor cores or TMA.
//
// A structured forcing (pallas_box3d_rkc.py:176-208, 605-622) comes in as
// K2's does (fused_rkc.cu) with K6's depth table (fused_box3d.cu): one
// amplitude column when every stimulus is segment-gated, else one a
// Chebyshev stage time of this step's s (C_RKC + 2 columns, computed on the
// device from the s the launch reads); evaluation e at plane k adds
// ((amps[j][a] * z[j][k]) * rows[j][r]) * cols[j][c], a =
// rhs_common.cuh::rkc_amp_column(e), before the live factor and the tissue
// field, in both schemes (in the chunk kernel at the plane p - i that
// evaluation i of the chunk reaches in iteration p). The forced
// instantiations are compiled apart, in fused_box3d_rkc_forced.cu.

#include <cuda_runtime.h>

#include "box3d.cuh"
#include "box_rkc_stream.cuh"

// min_tiles: the stream scheme's blocks a launch should reach
// (ops/box_stream.py RKC_MIN_TILES), unused by the persistent one; work:
// three states of y's shape
#define CRD_FUSED_BOX3D_RKC_ARGS                                             \
  const void *y, void *y_new, void *ss, int capacity, int *n_blocks,        \
      void *work, const void *h, const void *fz, const void *s,             \
      const void *mu1_tab, const void *ctab, int s_cap, int min_tiles,      \
      CRD_BOX_OPERATOR_ARGS
#define CRD_FUSED_BOX3D_RKC_PASS                                             \
  y, y_new, ss, capacity, n_blocks, work, h, fz, s, mu1_tab, ctab, s_cap,   \
      min_tiles, CRD_BOX_OPERATOR_PASS

namespace crd_k7 {

using crd::BoxConstants;
using crd::kBoxThreads;

constexpr int kMaxStages = 23;    // ops/fused_rkc.py S_MAX_KERNEL: ctab rows

// The persistent scheme's step.
template <int Mode, int Kin, typename T, class Stim>
__global__ void __launch_bounds__(kBoxThreads) fused_box3d_rkc_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    T* work, const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    const int* __restrict__ s_ptr, const T* __restrict__ mu1_tab,
    const T* __restrict__ ctab, int s_cap, BoxConstants<T> c, T rtol,
    T atol, Stim stim) {
  __shared__ T warp_sums[kBoxThreads / 32];
  const size_t n = static_cast<size_t>(c.nz) * c.ny * c.nx;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const int s = *s_ptr;
  if (s < 2 || s > s_cap) {
    // no table row for this stage count (uniform: every block leaves
    // before any barrier): keep y, poison the error sum
    for (size_t g = first; g < 2 * n; g += stride) y_new[g] = y[g];
    if (threadIdx.x == 0) ss[blockIdx.x] = crd::quiet_nan<T>();
    return;
  }
  crd::cg::grid_group grid = crd::cg::this_grid();
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  T* f0 = work;                 // F0 = f(y0), both variables
  T* ya = work + 2 * n;         // Y1, then Yj in turns with yb
  T* yb = work + 4 * n;

  const T hmu1 = h * mu1_tab[s];
  for (size_t g = first; g < n; g += stride) {
    T du, dv;
    crd::box_rhs<Mode, Kin>(c, fz, stim, 0, y, y + n, g, du, dv);
    f0[g] = du;
    f0[n + g] = dv;
    ya[g] = y[g] + hmu1 * du;
    ya[n + g] = y[n + g] + hmu1 * dv;
  }
  grid.sync();

  const T* prev = y;            // Yj-2
  T* cur = ya;                  // Yj-1
  T* dst = yb;                  // Yj: yb at j = 2, then Yj-2's buffer
  const T* row = ctab + static_cast<size_t>(s) * (kMaxStages + 1) * 4;
  for (int j = 2; j <= s; ++j) {
    const T mu = row[4 * j], nu = row[4 * j + 1];
    const T mut = row[4 * j + 2], gt = row[4 * j + 3];
    const T cy0 = T(1) - mu - nu;
    const T hmut = h * mut, hgt = h * gt;
    const int a = crd::box_rkc_column(stim, j - 1);    // f(Yj-1)
    for (size_t g = first; g < n; g += stride) {
      T fu, fv;
      crd::box_rhs<Mode, Kin>(c, fz, stim, a, cur, cur + n, g, fu, fv);
      const T yju = cy0 * y[g] + mu * cur[g] + nu * prev[g] + hmut * fu
                    + hgt * f0[g];
      const T yjv = cy0 * y[n + g] + mu * cur[n + g] + nu * prev[n + g]
                    + hmut * fv + hgt * f0[n + g];
      dst[g] = yju;
      dst[n + g] = yjv;
    }
    grid.sync();
    prev = cur;
    T* old = cur;
    cur = dst;
    dst = old;
  }

  // F1 = f(y_new), y_new and the error; WRMS weights from the step's start
  const T h04 = T(0.4) * h;
  const int a1 = crd::box_rkc_column(stim, s);
  T acc = T(0);
  for (size_t g = first; g < n; g += stride) {
    T f1u, f1v;
    crd::box_rhs<Mode, Kin>(c, fz, stim, a1, cur, cur + n, g, f1u, f1v);
    const T yu = cur[g], yv = cur[n + g];
    const T u0 = y[g], v0 = y[n + g];
    y_new[g] = yu;
    y_new[n + g] = yv;
    const T eu = T(0.8) * (u0 - yu) + h04 * (f0[g] + f1u);
    const T ev = T(0.8) * (v0 - yv) + h04 * (f0[n + g] + f1v);
    const T wu = eu * (T(1) / (rtol * fabs(u0) + atol));
    const T wv = ev * (T(1) / (rtol * fabs(v0) + atol));
    acc = acc + wu * wu;
    acc = acc + wv * wv;
  }
  crd::store_block_sum<T, kBoxThreads>(acc, warp_sums, ss);
}

// One step with the forcing `stim` (NoStim: none), in the mode's scheme.
template <typename T, class Stim>
int launch_stim(CRD_FUSED_BOX3D_RKC_ARGS, const Stim& stim) {
  BoxConstants<T> c;
  const void* const coeffs[6] = {c0, c1, c2, c3, c4, c5};
  if (s_cap < 2 || s_cap > crd::kRkcStreamStages
      || !crd::make_box_constants<T>(coeffs, tissue, invs, mode, beta,
                                     beta_field, mask, has_freeze, nz, ny,
                                     nx, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (crd::rkc_stream_take(mode))
    return crd::launch_box_rkc_stream<T>(
        c, crd::StreamWrap{ny, nx}, mode, kinetics, y, y_new, ss, capacity,
        n_blocks, work, h, fz, s, mu1_tab, ctab, s_cap, min_tiles, rtol,
        atol, stream, stim);
  const T* y_arg = static_cast<const T*>(y);
  T* ynew_arg = static_cast<T*>(y_new);
  T* ss_arg = static_cast<T*>(ss);
  T* work_arg = static_cast<T*>(work);
  const T* h_arg = static_cast<const T*>(h);
  const T* fz_arg = static_cast<const T*>(fz);
  const int* s_arg = static_cast<const int*>(s);
  const T* mu1_arg = static_cast<const T*>(mu1_tab);
  const T* ctab_arg = static_cast<const T*>(ctab);
  T rtol_arg = static_cast<T>(rtol), atol_arg = static_cast<T>(atol);
  Stim stim_arg = stim;
  void* args[] = {&y_arg, &ynew_arg, &ss_arg, &work_arg, &h_arg,
                  &fz_arg, &s_arg, &mu1_arg, &ctab_arg, &s_cap,
                  &c, &rtol_arg, &atol_arg, &stim_arg};
  const size_t n_points = static_cast<size_t>(nz) * ny * nx;
  return crd::dispatch_box(mode, kinetics, [&](auto m, auto k) {
    return crd::launch_cooperative(
        &fused_box3d_rkc_kernel<decltype(m)::value, decltype(k)::value, T,
                                Stim>,
        n_points, capacity, n_blocks, args, stream);
  });
}

// The forced launches, defined in fused_box3d_rkc_forced.cu.
int launch_forced(CRD_FUSED_BOX3D_RKC_ARGS,
                  const crd::BoxStimTable<float>& stim);
int launch_forced(CRD_FUSED_BOX3D_RKC_ARGS,
                  const crd::BoxStimTable<double>& stim);

}  // namespace crd_k7

#ifndef CRD_BOX_FORCED_UNIT

namespace {

// The launch of a step with or without a forcing: n_cols must be 1 (every
// stimulus segment-gated) or s_cap + 2 (a column a stage time).
template <typename T>
int launch(CRD_FUSED_BOX3D_RKC_ARGS, CRD_BOX_STIM_ARGS) {
  return crd::with_box_stim<T>(
      CRD_BOX_STIM_PASS, n_cols == 1 || n_cols == s_cap + 2, nz, ny, nx,
      [&](auto stim) {
        if constexpr (decltype(stim)::kOn)
          return crd_k7::launch_forced(CRD_FUSED_BOX3D_RKC_PASS, stim);
        else
          return crd_k7::launch_stim<T>(CRD_FUSED_BOX3D_RKC_PASS, stim);
      });
}

}  // namespace

extern "C" int crd_fused_box3d_rkc_step_f32(CRD_FUSED_BOX3D_RKC_ARGS,
                                            CRD_BOX_STIM_ARGS) {
  return launch<float>(CRD_FUSED_BOX3D_RKC_PASS, CRD_BOX_STIM_PASS);
}

extern "C" int crd_fused_box3d_rkc_step_f64(CRD_FUSED_BOX3D_RKC_ARGS,
                                            CRD_BOX_STIM_ARGS) {
  return launch<double>(CRD_FUSED_BOX3D_RKC_PASS, CRD_BOX_STIM_PASS);
}

// The unforced stream scheme's kernel of (mode, kinetics) on the whole box:
// out[0] blocks an SM, out[1] registers a thread, out[2] shared bytes a
// block (ops/box_stream.py::kernel_info).
extern "C" int crd_fused_box3d_rkc_info(int f64, int mode, int kinetics,
                                        int* out) {
  return f64 ? crd::rkc_stream_kernel_info<double, crd::StreamWrap>(
                   mode, kinetics, out)
             : crd::rkc_stream_kernel_info<float, crd::StreamWrap>(
                   mode, kinetics, out);
}

#endif  // CRD_BOX_FORCED_UNIT
