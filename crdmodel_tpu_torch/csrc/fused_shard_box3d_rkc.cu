// Fused RKC2 step on one shard of the 3-D box, with FitzHugh-Nagumo,
// Goldbeter or Aliev-Panfilov kinetics, in the box operator's four modes
// (kernel K13 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_shard_box3d_rkc.py::
// build_fused_shard_box3d_rkc, the Pallas TPU kernel that takes every
// attempted step of a sharded rkc2 run on a box. It is K7
// (fused_box3d_rkc.cu) on one shard, with K12's layout (fused_shard_box3d.cu):
// one exchange of width halo a step fills the (y, x) halo of the shard's
// (2, nz, nyl + 2 halo, nxl + 2 halo) buffer, and one step computes the
// s Chebyshev stages
//   F0 = f(y0), Y1 = y0 + (h mu1) F0, for j = 2..s
//   Yj = (1 - mu - nu) y0 + mu Yj-1 + nu Yj-2 + (h mut) f(Yj-1) + (h gt) F0,
// y_new = Ys and F1 = f(y_new) on the block, est = 0.8 (y0 - y_new) +
// (0.4 h)(F0 + F1), and partial sums of squared WRMS-scaled errors over
// the PHYSICAL cells, in a fixed order. s, h, the
// freeze scalar and the coefficient tables live on the device; the caller
// max-reduces the spectral-radius bound across the shards, so every shard
// runs the same s. An s outside [2, s_cap] keeps y and returns NaN partial
// sums, which the adaptive loop rejects.
//
// The block's cone: F1 on the block needs Ys on 1 ring, Yj on s + 1 - j
// rings, F0 and Y1 on s rings, so y0 on s + 1 <= halo rings: the launcher
// takes s_cap <= halo - 1, and with the exchange's 8 rings the TPU kernel's
// stage cap C_RKC = 7 is this kernel's bound too. Mirror-pad cells step
// like their sources and stay out of the sums.
//
// What bounds it on an H100: as K12, the buffer read once and y_new's
// block written once whatever s (36 MB at the sharded slab's shard in f32,
// some 11 us at 3.35 TB/s); at s = 7 the arithmetic of s + 1 right-hand
// sides a point comes close.
//
// Design: K7's two schemes on the shard, chosen on the mode alike
// (box_rkc_stream.cuh::rkc_stream_take). The tensor mode runs K7's chunks
// (box_rkc_stream.cuh, StreamHalo): each chunk a z-streaming launch over
// 32 x 16 tiles of the block grown by the evaluations still to come
// (ops/fused_shard_rkc.py::extent_rings with depth 4: the block and 4
// rings at s = 7, read 8 rings out), so the exchange's halo holds the
// whole step and the chunks exchange nothing; the last chunk's tiles are
// the block's. The other modes run the persistent scheme on a ladder of
// rings: F0 and Y1 on the block and s rings around it, Yj on s + 1 - j
// rings, F1 on the block; the live set (F0, Yj-1, Yj-2) in three scratch
// states of the buffer's size, a grid barrier between stages; Yj
// overwrites Yj-2 in place (a point reads Yj-2 only at itself, and Yj's
// rings lie inside Yj-2's). No tensor cores or TMA.
//
// A structured forcing (pallas_shard_box3d_rkc.py:166-181, 716-722) comes
// in as K7's does (fused_box3d_rkc.cu), its table of one or s_cap + 2
// columns computed once a step on the control device from the s every
// shard runs, with K12's profiles halo-padded to the buffer and the whole
// box's depth table (fused_shard_box3d.cu). The forced instantiations are
// compiled apart, in fused_shard_box3d_rkc_forced.cu.

#include <cuda_runtime.h>

#include "box3d.cuh"
#include "box_rkc_stream.cuh"

#define CRD_FUSED_SHARD_BOX3D_RKC_ARGS                                       \
  const void *y, void *y_new, void *ss, int capacity, int *n_blocks,        \
      void *work, const void *h, const void *fz, const void *s,             \
      const void *mu1_tab, const void *ctab, int s_cap, int min_tiles,      \
      int halo, int valid_rows, int valid_cols, CRD_BOX_OPERATOR_ARGS
#define CRD_FUSED_SHARD_BOX3D_RKC_PASS                                       \
  y, y_new, ss, capacity, n_blocks, work, h, fz, s, mu1_tab, ctab, s_cap,   \
      min_tiles, halo, valid_rows, valid_cols, CRD_BOX_OPERATOR_PASS

namespace crd_k13 {

using crd::BoxConstants;
using crd::BoxHalo;
using crd::BoxRing;
using crd::BoxShard;
using crd::kBoxThreads;

constexpr int kMaxStages = 23;    // ops/fused_rkc.py S_MAX_KERNEL: ctab rows

// The persistent scheme's step.
template <int Mode, int Kin, typename T, class Stim>
__global__ void __launch_bounds__(kBoxThreads) fused_shard_box3d_rkc_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    T* work, const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    const int* __restrict__ s_ptr, const T* __restrict__ mu1_tab,
    const T* __restrict__ ctab, int s_cap, BoxConstants<T> c, BoxShard sh,
    T rtol, T atol, Stim stim) {
  __shared__ T warp_sums[kBoxThreads / 32];
  const size_t n = static_cast<size_t>(c.nz) * c.ny * c.nx;   // the buffer
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
  const BoxRing first_stage(sh, c.nz, s);
  for (size_t q = first; q < first_stage.size(); q += stride) {
    int k, j, i;
    first_stage.point(q, k, j, i);
    const size_t g = c.at(k, j, i);
    T du, dv;
    crd::box_rhs_at<Mode, Kin, BoxHalo>(c, fz, stim, 0, y, y + n, k, j, i, g,
                                        du, dv);
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
  for (int st = 2; st <= s; ++st) {
    const T mu = row[4 * st], nu = row[4 * st + 1];
    const T mut = row[4 * st + 2], gt = row[4 * st + 3];
    const T cy0 = T(1) - mu - nu;
    const T hmut = h * mut, hgt = h * gt;
    const int a = crd::box_rkc_column(stim, st - 1);    // f(Yst-1)
    const BoxRing stage(sh, c.nz, s + 1 - st);
    for (size_t q = first; q < stage.size(); q += stride) {
      int k, j, i;
      stage.point(q, k, j, i);
      const size_t g = c.at(k, j, i);
      T fu, fv;
      crd::box_rhs_at<Mode, Kin, BoxHalo>(c, fz, stim, a, cur, cur + n, k, j,
                                          i, g, fu, fv);
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

  // F1 = f(y_new), y_new on the block and the error on its physical cells;
  // WRMS weights from the step's start
  const T h04 = T(0.4) * h;
  const int a1 = crd::box_rkc_column(stim, s);
  T acc = T(0);
  const BoxRing block(sh, c.nz, 0);
  for (size_t q = first; q < block.size(); q += stride) {
    int k, j, i;
    block.point(q, k, j, i);
    const size_t g = c.at(k, j, i);
    T f1u, f1v;
    crd::box_rhs_at<Mode, Kin, BoxHalo>(c, fz, stim, a1, cur, cur + n, k, j,
                                        i, g, f1u, f1v);
    const T yu = cur[g], yv = cur[n + g];
    const T u0 = y[g], v0 = y[n + g];
    y_new[g] = yu;
    y_new[n + g] = yv;
    if (sh.counted(j, i)) {
      const T eu = T(0.8) * (u0 - yu) + h04 * (f0[g] + f1u);
      const T ev = T(0.8) * (v0 - yv) + h04 * (f0[n + g] + f1v);
      const T wu = eu * (T(1) / (rtol * fabs(u0) + atol));
      const T wv = ev * (T(1) / (rtol * fabs(v0) + atol));
      acc = acc + wu * wu;
      acc = acc + wv * wv;
    }
  }
  crd::store_block_sum<T, kBoxThreads>(acc, warp_sums, ss);
}

// One step with the forcing `stim` (NoStim: none), in the mode's scheme.
template <typename T, class Stim>
int launch_stim(CRD_FUSED_SHARD_BOX3D_RKC_ARGS, const Stim& stim) {
  BoxConstants<T> c;
  BoxShard sh;
  const void* const coeffs[6] = {c0, c1, c2, c3, c4, c5};
  if (s_cap < 2 || s_cap > crd::kRkcStreamStages
      || !crd::make_box_shard(ny, nx, halo, s_cap + 1, valid_rows,
                              valid_cols, &sh)
      || !crd::make_box_constants<T>(coeffs, tissue, invs, mode, beta,
                                     beta_field, mask, has_freeze, nz, ny,
                                     nx, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (crd::rkc_stream_take(mode))
    return crd::launch_box_rkc_stream<T>(
        c, crd::StreamHalo{sh, ny, nx}, mode, kinetics, y, y_new, ss,
        capacity, n_blocks, work, h, fz, s, mu1_tab, ctab, s_cap, min_tiles,
        rtol, atol, stream, stim);
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
                  &c, &sh, &rtol_arg, &atol_arg, &stim_arg};
  const size_t n_points = static_cast<size_t>(nz) * ny * nx;
  return crd::dispatch_box(mode, kinetics, [&](auto m, auto k) {
    return crd::launch_cooperative(
        &fused_shard_box3d_rkc_kernel<decltype(m)::value, decltype(k)::value,
                                      T, Stim>,
        n_points, capacity, n_blocks, args, stream);
  });
}

// The forced launches, defined in fused_shard_box3d_rkc_forced.cu.
int launch_forced(CRD_FUSED_SHARD_BOX3D_RKC_ARGS,
                  const crd::BoxStimTable<float>& stim);
int launch_forced(CRD_FUSED_SHARD_BOX3D_RKC_ARGS,
                  const crd::BoxStimTable<double>& stim);

}  // namespace crd_k13

#ifndef CRD_BOX_FORCED_UNIT

namespace {

// The launch of a step with or without a forcing, whose profiles are
// halo-padded to the buffer (ny x nx): n_cols must be 1 or s_cap + 2.
template <typename T>
int launch(CRD_FUSED_SHARD_BOX3D_RKC_ARGS, CRD_BOX_STIM_ARGS) {
  return crd::with_box_stim<T>(
      CRD_BOX_STIM_PASS, n_cols == 1 || n_cols == s_cap + 2, nz, ny, nx,
      [&](auto stim) {
        if constexpr (decltype(stim)::kOn)
          return crd_k13::launch_forced(CRD_FUSED_SHARD_BOX3D_RKC_PASS,
                                        stim);
        else
          return crd_k13::launch_stim<T>(CRD_FUSED_SHARD_BOX3D_RKC_PASS,
                                         stim);
      });
}

}  // namespace

extern "C" int crd_fused_shard_box3d_rkc_step_f32(
    CRD_FUSED_SHARD_BOX3D_RKC_ARGS, CRD_BOX_STIM_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_BOX3D_RKC_PASS, CRD_BOX_STIM_PASS);
}

extern "C" int crd_fused_shard_box3d_rkc_step_f64(
    CRD_FUSED_SHARD_BOX3D_RKC_ARGS, CRD_BOX_STIM_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_BOX3D_RKC_PASS, CRD_BOX_STIM_PASS);
}

extern "C" int crd_fused_shard_box3d_rkc_info(int f64, int mode,
                                              int kinetics, int* out) {
  return f64 ? crd::rkc_stream_kernel_info<double, crd::StreamHalo>(
                   mode, kinetics, out)
             : crd::rkc_stream_kernel_info<float, crd::StreamHalo>(
                   mode, kinetics, out);
}

#endif  // CRD_BOX_FORCED_UNIT
