// Fused embedded-ERK step on one shard of the 3-D box, with FitzHugh-Nagumo,
// Goldbeter or Aliev-Panfilov kinetics, in the box operator's four modes
// (kernel K12 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_shard_box3d.py::build_fused_shard_box3d,
// the Pallas TPU kernel that takes every attempted step of a sharded ERK
// run on a box (the JAX package's pod-scale volumetric path). It is K6
// (fused_box3d.cu) on one shard of a mesh that splits y and x and keeps z:
// one exchange of width halo >= n_stages a step (parallel/halo.py::
// refresh_halos) fills the (y, x) halo of the shard's (2, nz, nyl + 2 halo,
// nxl + 2 halo) buffer, and one launch computes every stage, y_new on the
// block and one partial sum of squared WRMS-scaled errors per thread block
// over the PHYSICAL cells, in a fixed order, so two launches give bitwise
// equal results. The caller adds every shard's partials in a fixed order,
// so every shard takes the same accept/reject decision.
//
// The stage ladder: y_new on the block needs every k_s there; k_s on the
// block and r rings around it needs its stage input on r + 1 rings, which
// needs k_j (j < s) there. So k_s runs on n_stages - 1 - s rings, its
// input on one more, and k_0 reads y on n_stages <= halo rings: the
// exchange's. Each stage walks only its ring region, and the operator reads
// its neighbours and the shard's halo-padded constants through the BoxHalo
// policy (box3d.cuh): no index wraps; a read across the shard edge meets
// the neighbour shard's value, which the exchange (the state) or the
// once-a-run halo padding (the constants, ops/kernel_common.py::
// make_shard_box_constants) put there. On a padded mesh, mirror-pad cells
// step like their sources and stay out of the sum (BoxShard::counted).
// Only the block of y_new is written; its halo is the next exchange's.
//
// What bounds it on an H100: as K6, the buffer read once and y_new's block
// written once, 2 x 32 x 272 x 272 plus 2 x 32 x 256 x 256 values at the
// sharded slab's shard (36 MB in f32, some 11 us at 3.35 TB/s), plus the
// constants once; the arithmetic stays far below the card's rate.
//
// Design: K6's two schemes on the halo-padded buffer's layout. bs32 runs
// box_stream.cuh's z-streaming pass (StreamHalo): the tiles cover the
// block, each reading its rings from the halo, and at the slab's 256 x 256
// shard the 128 tiles of 32 x 16 are cut into z chunks so that a launch
// fills a round of two blocks on each SM (ops/box_stream.py::stream_plan);
// one partial sum a tile and chunk over its physical cells. zonneveld43
// and dopri54 run the persistent scheme (box3d.cuh) on a ring ladder of
// stages, the stage values in device memory, a grid barrier between
// stages; the rings cost (nxl + 2r)(nyl + 2r) / (nxl nyl) of the block's
// work, about 1.1x at the slab's shard. The TPU kernel's row strips and
// DMA semaphores have no place here.
//
// A structured forcing (pallas_shard_box3d.py:196-213, 445-453, 723-724)
// comes in as K6's does (fused_box3d.cu): the step's amplitude table,
// computed once on the control device, each stimulus's row and column
// profiles halo-padded to the shard's buffer (ops/kernel_common.py::
// prepare_shard_stim_constants: the exchange's values, and on a padded mesh
// the mirror-pad cells' sources') and the whole box's depth table, z not
// being sharded. A point reads them at the buffer's (k, j, i) its state
// comes from (rhs_common.cuh::BoxStimTable). The forced instantiations are
// compiled apart, in fused_shard_box3d_forced.cu.

#include <cuda_runtime.h>

#include "box3d.cuh"
#include "box_stream.cuh"
#include "erk_tile.cuh"

#define CRD_FUSED_SHARD_BOX3D_ARGS                                           \
  const void *y, void *y_new, void *ss, int capacity, int *n_blocks,        \
      void *work, const void *h, const void *fz, int n_stages,              \
      const double *a, const double *b, const double *d, int halo,          \
      int valid_rows, int valid_cols, int tile_y, int z_chunk,              \
      CRD_BOX_OPERATOR_ARGS
#define CRD_FUSED_SHARD_BOX3D_PASS                                           \
  y, y_new, ss, capacity, n_blocks, work, h, fz, n_stages, a, b, d, halo,   \
      valid_rows, valid_cols, tile_y, z_chunk, CRD_BOX_OPERATOR_PASS

namespace crd_k12 {

using crd::BoxConstants;
using crd::BoxHalo;
using crd::BoxRing;
using crd::BoxShard;
using crd::StageTable;
using crd::kBoxThreads;

template <int Mode, int Kin, typename T, class Stim>
__global__ void __launch_bounds__(kBoxThreads) fused_shard_box3d_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    T* work, const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    BoxConstants<T> c, StageTable tab, BoxShard sh, T rtol, T atol,
    Stim stim) {
  __shared__ T warp_sums[kBoxThreads / 32];
  crd::cg::grid_group grid = crd::cg::this_grid();
  const size_t n = static_cast<size_t>(c.nz) * c.ny * c.nx;   // the buffer
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  T* yi = work;                 // the current stage input, both variables
  T* ks = work + 2 * n;         // stage s: u at ks + 2sn, v after

  for (int s = 0; s < tab.n; ++s) {
    const int rings = tab.n - 1 - s;     // k_s's
    const T* arg = y;
    if (s > 0) {
      const BoxRing in(sh, c.nz, rings + 1);
      for (size_t q = first; q < in.size(); q += stride) {
        int k, j, i;
        in.point(q, k, j, i);
        const size_t g = c.at(k, j, i);
        T u = y[g], v = y[n + g];
        for (int p = 0; p < s; ++p) {
          if (tab.a[s][p] != 0.0) {
            const T ha = h * static_cast<T>(tab.a[s][p]);
            u = u + ha * ks[2 * p * n + g];
            v = v + ha * ks[(2 * p + 1) * n + g];
          }
        }
        yi[g] = u;
        yi[n + g] = v;
      }
      grid.sync();
      arg = yi;
    }
    T* ku = ks + 2 * s * n;
    const BoxRing out(sh, c.nz, rings);
    for (size_t q = first; q < out.size(); q += stride) {
      int k, j, i;
      out.point(q, k, j, i);
      const size_t g = c.at(k, j, i);
      crd::box_rhs_at<Mode, Kin, BoxHalo>(c, fz, stim, s, arg, arg + n, k, j,
                                          i, g, ku[g], ku[n + g]);
    }
    grid.sync();
  }

  // y_new on the block, the error on its physical cells; WRMS weights from
  // the step's start
  T acc = T(0);
  const BoxRing block(sh, c.nz, 0);
  for (size_t q = first; q < block.size(); q += stride) {
    int k, j, i;
    block.point(q, k, j, i);
    const size_t g = c.at(k, j, i);
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
    if (sh.counted(j, i)) {
      const T wu = eu * (T(1) / (rtol * fabs(u0) + atol));
      const T wv = ev * (T(1) / (rtol * fabs(v0) + atol));
      acc = acc + wu * wu;
      acc = acc + wv * wv;
    }
  }
  crd::store_block_sum<T, kBoxThreads>(acc, warp_sums, ss);
}

// One step with the forcing `stim` (NoStim: none), in either scheme.
template <typename T, class Stim>
int launch_stim(CRD_FUSED_SHARD_BOX3D_ARGS, const Stim& stim) {
  StageTable tab;
  BoxConstants<T> c;
  BoxShard sh;
  const void* const coeffs[6] = {c0, c1, c2, c3, c4, c5};
  if (n_stages < 2 || !crd::make_stage_table(n_stages, a, b, d, &tab)
      || !crd::make_box_shard(ny, nx, halo, n_stages, valid_rows,
                              valid_cols, &sh)
      || !crd::make_box_constants<T>(coeffs, tissue, invs, mode, beta,
                                     beta_field, mask, has_freeze, nz, ny,
                                     nx, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (crd::stream_take(tab))
    return crd::launch_box_stream<T>(c, crd::StreamHalo{sh, ny, nx}, mode,
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
                  &c, &tab, &sh, &rtol_arg, &atol_arg, &stim_arg};
  const size_t n_points = static_cast<size_t>(nz) * ny * nx;
  return crd::dispatch_box(mode, kinetics, [&](auto m, auto k) {
    return crd::launch_cooperative(
        &fused_shard_box3d_kernel<decltype(m)::value, decltype(k)::value, T,
                                  Stim>,
        n_points, capacity, n_blocks, args, stream);
  });
}

// The forced launches, defined in fused_shard_box3d_forced.cu.
int launch_forced(CRD_FUSED_SHARD_BOX3D_ARGS,
                  const crd::BoxStimTable<float>& stim);
int launch_forced(CRD_FUSED_SHARD_BOX3D_ARGS,
                  const crd::BoxStimTable<double>& stim);

}  // namespace crd_k12

#ifndef CRD_BOX_FORCED_UNIT

namespace {

// The launch of a step with or without a forcing, whose profiles are
// halo-padded to the buffer (ny x nx): n_cols must be the tableau's stage
// count.
template <typename T>
int launch(CRD_FUSED_SHARD_BOX3D_ARGS, CRD_BOX_STIM_ARGS) {
  return crd::with_box_stim<T>(
      CRD_BOX_STIM_PASS, n_cols == n_stages, nz, ny, nx, [&](auto stim) {
        if constexpr (decltype(stim)::kOn)
          return crd_k12::launch_forced(CRD_FUSED_SHARD_BOX3D_PASS, stim);
        else
          return crd_k12::launch_stim<T>(CRD_FUSED_SHARD_BOX3D_PASS, stim);
      });
}

}  // namespace

extern "C" int crd_fused_shard_box3d_step_f32(CRD_FUSED_SHARD_BOX3D_ARGS,
                                              CRD_BOX_STIM_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_BOX3D_PASS, CRD_BOX_STIM_PASS);
}

extern "C" int crd_fused_shard_box3d_step_f64(CRD_FUSED_SHARD_BOX3D_ARGS,
                                              CRD_BOX_STIM_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_BOX3D_PASS, CRD_BOX_STIM_PASS);
}

// The unforced stream kernel of (mode, kinetics) on a shard's buffer:
// out[0] blocks an SM, out[1] registers a thread, out[2] shared bytes a
// block (ops/box_stream.py::kernel_info).
extern "C" int crd_fused_shard_box3d_info(int f64, int mode, int kinetics,
                                          int* out) {
  return f64 ? crd::stream_kernel_info<double, crd::StreamHalo>(
                   mode, kinetics, out)
             : crd::stream_kernel_info<float, crd::StreamHalo>(
                   mode, kinetics, out);
}

#endif  // CRD_BOX_FORCED_UNIT
