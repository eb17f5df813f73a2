// Fused embedded-ERK step on the 3-D box, with FitzHugh-Nagumo, Goldbeter
// or Aliev-Panfilov kinetics, in the box operator's four modes (kernel K6
// of the port).
//
// Replaces crdmodel_tpu/ops/pallas_box3d.py::build_fused_box3d_step, the
// Pallas TPU kernel that takes every attempted step of an ERK run on a box
// (the volumetric cardiac slab). One launch performs a whole step: stage
// inputs y0 + sum (h a[s][j]) k_j, k_s = kinetics + the box operator on
// variable 0, y_new = y0 + sum (h b_s) k_s and err = sum (h d_s) k_s in the
// plain version's order, and partial sums of (err / (rtol |y0| + atol))^2
// in a fixed order (no float atomics), so two launches give bitwise-equal
// results.
//
// What bounds it on an H100: the step must read the state (2 x nz x ny x
// nx) once and write y_new once, 134 MB at 32x512x512 in f32, some 40 us at
// the published 3.35 TB/s, plus each coefficient field once (3 or 6 more
// (nz, ny, nx) fields in the field and tensor modes). The arithmetic, some
// 40 to 90 operations a point a stage, is far below the card's rate.
//
// Design: two schemes, chosen by the launcher on the tableau. bs32, the
// main paths' (an FSAL tableau of four stages), runs box_stream.cuh's
// z-streaming pass: one block a 32 x 16 tile and z chunk, the stage
// inputs' variable 0 in rings of three planes in shared memory, everything
// pointwise in registers, so y is read about once and no stage value goes
// to device memory; one partial sum a tile and chunk. The other tableaus
// the gate takes (zonneveld43, dopri54: dopri54's 7 stages would need 7
// rings of 3 planes on a 7-ring region) run the persistent scheme
// (box3d.cuh): one cooperative launch, each stage writes its input y0 +
// sum (h a) k_j to device memory, a grid barrier, then k_s = f(input) at
// every point, another barrier, one partial sum a resident block; some 2 +
// 3s state sweeps a step where the bound is 2. No tensor cores or TMA.
//
// A structured forcing (core/forcing.py::SeparableForcing, rank-1 stimuli,
// each with an optional depth profile; pallas_box3d.py:360-394, 654-667,
// 781-782) comes in as an amplitude table amps[n_stim][n_stages], computed
// on the device at the stage times before the launch, each stimulus's row
// and column profiles and an (n_stim, nz) depth table (ones where a
// stimulus has none): stage s at plane k adds ((amps[j][s] * z[j][k]) *
// rows[j][r]) * cols[j][c] before the freeze's live factor and the tissue
// field (rhs_common.cuh::BoxStimTable), in the stream scheme at the plane
// q = p - s it evaluates in iteration p. Without a forcing (n_stim = 0) the
// launcher takes the unforced instantiations (NoStim), which have none of
// it. The forced ones are compiled apart, in fused_box3d_forced.cu, which
// includes this file with CRD_BOX_FORCED_UNIT defined, so that the two
// halves of the build run side by side.

#include <cuda_runtime.h>

#include "box3d.cuh"
#include "box_stream.cuh"
#include "erk_tile.cuh"

// tile_y and z_chunk: the stream scheme's plan (ops/box_stream.py::
// stream_plan), unused by the persistent one; work: the persistent
// scheme's scratch, unused by the stream one
#define CRD_FUSED_BOX3D_ARGS                                                 \
  const void *y, void *y_new, void *ss, int capacity, int *n_blocks,        \
      void *work, const void *h, const void *fz, int n_stages,              \
      const double *a, const double *b, const double *d, int tile_y,        \
      int z_chunk, CRD_BOX_OPERATOR_ARGS
#define CRD_FUSED_BOX3D_PASS                                                 \
  y, y_new, ss, capacity, n_blocks, work, h, fz, n_stages, a, b, d, tile_y, \
      z_chunk, CRD_BOX_OPERATOR_PASS

namespace crd_k6 {

using crd::BoxConstants;
using crd::StageTable;
using crd::kBoxThreads;

template <int Mode, int Kin, typename T, class Stim>
__global__ void __launch_bounds__(kBoxThreads) fused_box3d_step_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    T* work, const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    BoxConstants<T> c, StageTable tab, T rtol, T atol, Stim stim) {
  __shared__ T warp_sums[kBoxThreads / 32];
  crd::cg::grid_group grid = crd::cg::this_grid();
  const size_t n = static_cast<size_t>(c.nz) * c.ny * c.nx;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  T* yi = work;                 // the current stage input, both variables
  T* ks = work + 2 * n;         // stage s: u at ks + 2sn, v after

  for (int s = 0; s < tab.n; ++s) {
    const T* arg = y;
    if (s > 0) {
      for (size_t g = first; g < n; g += stride) {
        T u = y[g], v = y[n + g];
        for (int j = 0; j < s; ++j) {
          if (tab.a[s][j] != 0.0) {
            const T ha = h * static_cast<T>(tab.a[s][j]);
            u = u + ha * ks[2 * j * n + g];
            v = v + ha * ks[(2 * j + 1) * n + g];
          }
        }
        yi[g] = u;
        yi[n + g] = v;
      }
      grid.sync();
      arg = yi;
    }
    T* ku = ks + 2 * s * n;
    for (size_t g = first; g < n; g += stride)
      crd::box_rhs<Mode, Kin>(c, fz, stim, s, arg, arg + n, g, ku[g],
                              ku[n + g]);
    grid.sync();
  }

  // y_new and the error; WRMS weights from the step's start
  T acc = T(0);
  for (size_t g = first; g < n; g += stride) {
    const T u0 = y[g], v0 = y[n + g];
    T nu = u0, nv = v0, eu = T(0), ev = T(0);
    for (int s = 0; s < tab.n; ++s) {
      const T* ku = ks + 2 * s * n;
      if (tab.b[s] != 0.0) {
        const T hb = h * static_cast<T>(tab.b[s]);
        nu = nu + hb * ku[g];
        nv = nv + hb * ku[n + g];
      }
      if (tab.d[s] != 0.0) {
        const T hd = h * static_cast<T>(tab.d[s]);
        eu = eu + hd * ku[g];
        ev = ev + hd * ku[n + g];
      }
    }
    y_new[g] = nu;
    y_new[n + g] = nv;
    const T wu = eu * (T(1) / (rtol * fabs(u0) + atol));
    const T wv = ev * (T(1) / (rtol * fabs(v0) + atol));
    acc = acc + wu * wu;
    acc = acc + wv * wv;
  }
  crd::store_block_sum<T, kBoxThreads>(acc, warp_sums, ss);
}

// One step with the forcing `stim` (NoStim: none), in either scheme.
template <typename T, class Stim>
int launch_stim(CRD_FUSED_BOX3D_ARGS, const Stim& stim) {
  StageTable tab;
  BoxConstants<T> c;
  const void* const coeffs[6] = {c0, c1, c2, c3, c4, c5};
  if (n_stages < 2 || !crd::make_stage_table(n_stages, a, b, d, &tab)
      || !crd::make_box_constants<T>(coeffs, tissue, invs, mode, beta,
                                     beta_field, mask, has_freeze, nz, ny,
                                     nx, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (crd::stream_take(tab))
    return crd::launch_box_stream<T>(c, crd::StreamWrap{ny, nx}, mode,
                                     kinetics, y, y_new, ss, capacity,
                                     n_blocks, h, fz, tab, tile_y, z_chunk,
                                     rtol, atol, stream, stim);
  const T* y_arg = static_cast<const T*>(y);
  T* ynew_arg = static_cast<T*>(y_new);
  T* ss_arg = static_cast<T*>(ss);
  T* work_arg = static_cast<T*>(work);
  const T* h_arg = static_cast<const T*>(h);
  const T* fz_arg = static_cast<const T*>(fz);
  T rtol_arg = static_cast<T>(rtol), atol_arg = static_cast<T>(atol);
  Stim stim_arg = stim;
  void* args[] = {&y_arg, &ynew_arg, &ss_arg, &work_arg, &h_arg, &fz_arg,
                  &c, &tab, &rtol_arg, &atol_arg, &stim_arg};
  const size_t n_points = static_cast<size_t>(nz) * ny * nx;
  return crd::dispatch_box(mode, kinetics, [&](auto m, auto k) {
    return crd::launch_cooperative(
        &fused_box3d_step_kernel<decltype(m)::value, decltype(k)::value, T,
                                 Stim>,
        n_points, capacity, n_blocks, args, stream);
  });
}

// The forced launches, defined in fused_box3d_forced.cu.
int launch_forced(CRD_FUSED_BOX3D_ARGS,
                  const crd::BoxStimTable<float>& stim);
int launch_forced(CRD_FUSED_BOX3D_ARGS,
                  const crd::BoxStimTable<double>& stim);

}  // namespace crd_k6

#ifndef CRD_BOX_FORCED_UNIT

namespace {

// The launch of a step with or without a forcing: n_cols must be the
// tableau's stage count.
template <typename T>
int launch(CRD_FUSED_BOX3D_ARGS, CRD_BOX_STIM_ARGS) {
  return crd::with_box_stim<T>(
      CRD_BOX_STIM_PASS, n_cols == n_stages, nz, ny, nx, [&](auto stim) {
        if constexpr (decltype(stim)::kOn)
          return crd_k6::launch_forced(CRD_FUSED_BOX3D_PASS, stim);
        else
          return crd_k6::launch_stim<T>(CRD_FUSED_BOX3D_PASS, stim);
      });
}

}  // namespace

extern "C" int crd_fused_box3d_step_f32(CRD_FUSED_BOX3D_ARGS,
                                        CRD_BOX_STIM_ARGS) {
  return launch<float>(CRD_FUSED_BOX3D_PASS, CRD_BOX_STIM_PASS);
}

extern "C" int crd_fused_box3d_step_f64(CRD_FUSED_BOX3D_ARGS,
                                        CRD_BOX_STIM_ARGS) {
  return launch<double>(CRD_FUSED_BOX3D_PASS, CRD_BOX_STIM_PASS);
}

// The unforced stream kernel of (mode, kinetics) on the whole box: out[0]
// blocks an SM, out[1] registers a thread, out[2] shared bytes a block
// (ops/box_stream.py::kernel_info).
extern "C" int crd_fused_box3d_info(int f64, int mode, int kinetics,
                                    int* out) {
  return f64 ? crd::stream_kernel_info<double, crd::StreamWrap>(
                   mode, kinetics, out)
             : crd::stream_kernel_info<float, crd::StreamWrap>(
                   mode, kinetics, out);
}

#endif  // CRD_BOX_FORCED_UNIT
