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
// each added in the order of the one-pass tile kernel (rkc_tile.cuh) at
// these tiles, so that a run's error sums, and with them its accepted and
// rejected steps, are those of that kernel: rkc2's f32 error estimate sits
// at the rounding floor between waves, where the order of a sum decides
// steps.
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
// Design: the s + 1 RHS evaluations (F0 with Y1, the s - 1 stages, F1)
// run in chunks of at most kChunk = D, split evenly (chunk c of C =
// ceil((s+1)/D) takes evaluations [c (s+1) / C, (c+1) (s+1) / C);
// ops/fused_rkc.py::chunk_schedule). A chunk is a pass over 32x32 tiles
// whose regions carry a halo of the chunk's own evaluations, one ring an
// evaluation, so a step with s + 1 <= D is one pass, and the halo never
// grows with s. Between chunks, each tile's Yj-1 and Yj-2 (and, after the
// first, F0) go through device memory (`work`, ten planes: F0 and two
// pairs in turns, so that a chunk reads its neighbours' pair while it
// writes its own), and the grid waits at a barrier: one persistent
// cooperative launch (box3d.cuh::launch_cooperative), s on the device.
// Shared memory holds y0, F0 and the stencil's plane (Yj-1's u, two
// buffers, so one block barrier an evaluation) on the D-ring region,
// sized for D whatever s; the recurrence's pointwise values (Yj-2 and
// Yj-1's v) stay in the registers of the point's thread under a fixed map
// of threads onto the region (tile_slots.cuh). Indices wrap only where a
// region leaves the grid, any number of times on grids smaller than the
// halo; a tile inside the grid takes code without the wrap. Every
// evaluation runs at each point of the region, the rings whose values no
// longer matter included, so the slots' code has no branches. Each
// point's arithmetic follows the plain version (ops/
// fused_rkc.py::fused_rkc_step_reference) operation for operation,
// wherever it is computed, and the library is built with -fmad=false. The
// right-hand side at a point is a functor the kernel template takes:
// ProfileRhs, or DivformRhs (K4's operator, whose face coefficients are
// read through the read-only data cache), each over the kinetics family.
// K9 (fused_shard_rkc.cu) keeps rkc_tile.cuh's one-pass scheme. No tensor
// cores, TMA or tuning yet.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "box3d.cuh"
#include "rhs_common.cuh"
#include "rkc_tile.cuh"
#include "tile_slots.cuh"

namespace {

using crd::TileOrigin;

constexpr int kThreads = 512;                // ops/fused_rkc.py CHUNK_THREADS
constexpr int kTile = 32;                    // ops/fused_rkc.py CHUNK_TILE
constexpr int kChunk = 6;                    // ops/fused_rkc.py CHUNK
using Reg = crd::SlotRegion<kTile + 2 * kChunk, kTile + 2 * kChunk,
                            kThreads>;
// shared: y0 and F0, two variables each, and Yj-1's u twice, each plane
// guarded for the stencil (tile_slots.cuh)
constexpr int kPlanes = 6;

// f32: two blocks an SM (at most 64 registers); f64: one
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;

template <typename T>
constexpr size_t kSmem = static_cast<size_t>(kPlanes) * Reg::kStride
                         * sizeof(T);

// The launch's shape: the grid and the tiles over it.
struct RkcPlan {
  int ny;
  int nx;
  int tiles_x;
  int n_tiles;
};

template <typename T>
__device__ __forceinline__ void store_tile_sum(T acc, T* warp_sums, T* out) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    *out = total;
  }
  __syncthreads();
}

template <class Rhs, typename T>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T>))
    fused_rkc_chunk_kernel(const T* __restrict__ y, T* __restrict__ y_new,
                           T* __restrict__ ss, T* work,
                           const T* __restrict__ h_ptr,
                           const T* __restrict__ fz_ptr,
                           const int* __restrict__ s_ptr,
                           const T* __restrict__ mu1_tab,
                           const T* __restrict__ ctab, int s_cap, Rhs rhs,
                           RkcPlan plan, T rtol, T atol) {
  constexpr int W = Reg::kW;
  constexpr int S = Reg::kSlots;
  constexpr int PS = Reg::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kThreads / 32];
  __shared__ T e2[2][kTile * kTile];  // a tile's squared scaled errors
  T* const y0u = reinterpret_cast<T*>(smem_raw) + Reg::kGuard;
  T* const y0v = y0u + PS;            // y0u: the step's start
  T* const f0u = y0u + 2 * PS;        // F0 = f(y0)
  T* const f0v = y0u + 3 * PS;
  T* const cu0 = y0u + 4 * PS;        // Yj-1's u, in turns
  T* const cu1 = y0u + 5 * PS;
  crd::cg::grid_group grid = crd::cg::this_grid();

  const int s = *s_ptr;
  const size_t plane = static_cast<size_t>(plan.ny) * plan.nx;
  if (s < 2 || s > s_cap) {
    // no table row for this stage count: keep y, poison the error sums
    for (int t = blockIdx.x; t < plan.n_tiles; t += gridDim.x) {
      const int ty0 = t / plan.tiles_x;
      const TileOrigin o(ty0 * kTile, (t - ty0 * plan.tiles_x) * kTile,
                         kChunk, W, Reg::kR, plan.ny, plan.nx);
#pragma unroll
      for (int m = 0; m < S; ++m) {
        const int p = Reg::point(m);
        if (!Reg::valid(m) || !Reg::inside(p, kChunk)) continue;
        const int ly = Reg::row(p), lx = Reg::col(p);
        if (!o.in_grid(ly, lx)) continue;
        const size_t g = o.at<false>(ly, lx);
        y_new[g] = y[g];
        y_new[plane + g] = y[plane + g];
      }
      if (threadIdx.x == 0) ss[t] = crd::quiet_nan<T>();
    }
    return;
  }

  const T h = *h_ptr;
  const T fz = *fz_ptr;
  const T hmu1 = h * mu1_tab[s];
  const T h04 = T(0.4) * h;
  const T* const row = ctab + static_cast<size_t>(s)
                                  * (crd::kRkcMaxStages + 1) * 4;
  const int n_evals = s + 1;
  const int n_chunks = (n_evals + kChunk - 1) / kChunk;
  T* const f0buf = work;              // F0 on the grid, after chunk 0
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) grid.sync();
    const int e0 = c * n_evals / n_chunks;
    const int e1 = (c + 1) * n_evals / n_chunks;
    const int off = kChunk - (e1 - e0);   // the region's unused rings
    // the pairs (Ye, Ye-1) a chunk hands on: u, v, u, v in turns
    const T* const rd = work + (2 + 4 * ((c + 1) & 1)) * plane;
    T* const wr = work + (2 + 4 * (c & 1)) * plane;
    for (int t = blockIdx.x; t < plan.n_tiles; t += gridDim.x) {
      const int ty0 = t / plan.tiles_x;
      const TileOrigin o(ty0 * kTile, (t - ty0 * plan.tiles_x) * kTile,
                         kChunk, W, Reg::kR, plan.ny, plan.nx);
      // the chunk on one tile; kIn: its region lies inside the grid
      const auto chunk = [&](auto inner) {
        constexpr bool kIn = decltype(inner)::value;
        T ycv[S], ypu[S], ypv[S];     // Yj-1's v, Yj-2 at the thread's points
#pragma unroll
        for (int m = 0; m < S; ++m) {
          ycv[m] = ypu[m] = ypv[m] = T(0);
          const int p = Reg::point(m);
          if (!Reg::valid(m) || !Reg::inside(p, off)) continue;
          const size_t g = o.at<kIn>(Reg::row(p), Reg::col(p));
          y0u[p] = y[g];
          y0v[p] = y[plane + g];
          if (c == 0) continue;
          f0u[p] = f0buf[g];
          f0v[p] = f0buf[plane + g];
          cu0[p] = rd[g];
          ycv[m] = rd[plane + g];
          ypu[m] = rd[2 * plane + g];
          ypv[m] = rd[3 * plane + g];
        }
        __syncthreads();
        // evaluation e is right on the points off + e - e0 + 1 rings in
        // and more; it runs at every point, the values further out unused
        bool second = false;          // Yj-1's u in cu1, not cu0
        for (int e = e0; e < e1; ++e) {
          T* const cur = second ? cu1 : cu0;
          T* const nxt = second ? cu0 : cu1;
          if (e == 0) {
            // F0 and Y1 = y0 + (h mu1) F0
#pragma unroll
            for (int m = 0; m < S; ++m) {
              if (!Reg::valid(m)) continue;
              const int p = Reg::point(m);
              const int ly = Reg::row(p), lx = Reg::col(p);
              const T u0 = y0u[p], v0 = y0v[p];
              T du, dv;
              rhs.at(fz, y0u, v0, p, W, o.row<kIn>(ly), o.col<kIn>(lx), du,
                     dv);
              f0u[p] = du;
              f0v[p] = dv;
              nxt[p] = u0 + hmu1 * du;
              ycv[m] = v0 + hmu1 * dv;
              ypu[m] = u0;
              ypv[m] = v0;
            }
          } else if (e < s) {
            // Yj, j = e + 1, from f(Yj-1)
            const int j = e + 1;
            const T mu = row[4 * j], nu = row[4 * j + 1];
            const T mut = row[4 * j + 2], gt = row[4 * j + 3];
            const T cy0 = T(1) - mu - nu;
            const T hmut = h * mut, hgt = h * gt;
#pragma unroll
            for (int m = 0; m < S; ++m) {
              if (!Reg::valid(m)) continue;
              const int p = Reg::point(m);
              const int ly = Reg::row(p), lx = Reg::col(p);
              T fu, fv;
              rhs.at(fz, cur, ycv[m], p, W, o.row<kIn>(ly), o.col<kIn>(lx),
                     fu, fv);
              const T cu = cur[p], cv = ycv[m];
              nxt[p] = cy0 * y0u[p] + mu * cu + nu * ypu[m] + hmut * fu
                       + hgt * f0u[p];
              ycv[m] = cy0 * y0v[p] + mu * cv + nu * ypv[m] + hmut * fv
                       + hgt * f0v[p];
              ypu[m] = cu;
              ypv[m] = cv;
            }
          } else {
            // F1 = f(y_new), y_new and the error on the tile; WRMS
            // weights from the step's start
#pragma unroll
            for (int m = 0; m < S; ++m) {
              const int p = Reg::point(m);
              if (!Reg::valid(m) || !Reg::inside(p, kChunk)) continue;
              const int ly = Reg::row(p), lx = Reg::col(p);
              const int q = (ly - kChunk) * kTile + lx - kChunk;
              if (!o.in_grid(ly, lx)) {   // adds +0.0 below: exact
                e2[0][q] = T(0);
                e2[1][q] = T(0);
                continue;
              }
              T f1u, f1v;
              rhs.at(fz, cur, ycv[m], p, W, o.row<kIn>(ly), o.col<kIn>(lx),
                     f1u, f1v);
              const T yu = cur[p], yv = ycv[m];
              const size_t g = o.at<kIn>(ly, lx);
              y_new[g] = yu;
              y_new[plane + g] = yv;
              const T eu = T(0.8) * (y0u[p] - yu) + h04 * (f0u[p] + f1u);
              const T ev = T(0.8) * (y0v[p] - yv) + h04 * (f0v[p] + f1v);
              const T wu = eu * (T(1) / (rtol * fabs(y0u[p]) + atol));
              const T wv = ev * (T(1) / (rtol * fabs(y0v[p]) + atol));
              e2[0][q] = wu * wu;
              e2[1][q] = wv * wv;
            }
          }
          second = !second;
          __syncthreads();
        }
        if (e1 == n_evals) {
          // the tile's sum in the one-pass kernel's order (rkc_tile.cuh,
          // 32x32 tiles of kThreads threads): thread t adds the points
          // t, t + kThreads, ... of the tile, u then v
          T acc = T(0);
          for (int q = threadIdx.x; q < kTile * kTile; q += kThreads) {
            acc = acc + e2[0][q];
            acc = acc + e2[1][q];
          }
          store_tile_sum(acc, warp_sums, ss + t);
          return;
        }
        // hand the tile's (Ye1, Ye1-1), and after chunk 0 F0, to the next
        // chunk; each thread reads only its own points here
        const T* const cur = second ? cu1 : cu0;
#pragma unroll
        for (int m = 0; m < S; ++m) {
          const int p = Reg::point(m);
          if (!Reg::valid(m) || !Reg::inside(p, kChunk)) continue;
          const int ly = Reg::row(p), lx = Reg::col(p);
          if (!o.in_grid(ly, lx)) continue;
          const size_t g = o.at<kIn>(ly, lx);
          wr[g] = cur[p];
          wr[plane + g] = ycv[m];
          wr[2 * plane + g] = ypu[m];
          wr[3 * plane + g] = ypv[m];
          if (c == 0) {
            f0buf[g] = f0u[p];
            f0buf[plane + g] = f0v[p];
          }
        }
      };
      if (o.inner)
        chunk(std::true_type{});
      else
        chunk(std::false_type{});
    }
  }
}

// f(kernel, rhs) for the kinetics id: DivformRhs when the face field aE is
// given, else ProfileRhs.
template <typename T, class F>
int dispatch(const crd::RhsConstants<T>& k, const crd::FaceConstants<T>& f,
             int ny, int nx, int kinetics, F go) {
  const crd::WrapGrid wg{ny, nx};
  const auto pick = [&](auto kin) {
    constexpr int Kin = decltype(kin)::value;
    if (f.aE != nullptr) {
      using Rhs = crd::DivformRhs<Kin, T, crd::WrapGrid>;
      return go(&fused_rkc_chunk_kernel<Rhs, T>, Rhs{f, k, wg});
    }
    using Rhs = crd::ProfileRhs<Kin, T>;
    return go(&fused_rkc_chunk_kernel<Rhs, T>, Rhs{k});
  };
  if (kinetics == crd::kFhn)
    return pick(std::integral_constant<int, crd::kFhn>{});
  if (kinetics == crd::kGoldbeter)
    return pick(std::integral_constant<int, crd::kGoldbeter>{});
  return pick(std::integral_constant<int, crd::kAlievPanfilov>{});
}

template <typename Kernel, typename T>
cudaError_t set_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem<T>));
}

template <typename T>
int launch(const void* y, void* y_new, void* ss, void* work, const void* h,
           const void* fz, const void* s, const void* mu1_tab,
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
  const int tiles_x = (nx + kTile - 1) / kTile;
  RkcPlan plan = {ny, nx, tiles_x, tiles_x * ((ny + kTile - 1) / kTile)};
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
  int n_blocks = 0;
  const size_t n_points = static_cast<size_t>(plan.n_tiles) * kThreads;
  return dispatch<T>(k, f, ny, nx, kinetics, [&](auto kernel, auto rhs) {
    const cudaError_t err = set_smem<decltype(kernel), T>(kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&y_arg, &ynew_arg, &ss_arg, &work_arg, &h_arg, &fz_arg,
                    &s_arg, &mu1_arg, &ctab_arg, &s_cap, &rhs, &plan,
                    &rtol_arg, &atol_arg};
    return crd::launch_cooperative(kernel, n_points, plan.n_tiles,
                                   &n_blocks, args, stream, kSmem<T>,
                                   kThreads);
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
  return dispatch<T>(crd::RhsConstants<T>{}, f, 1, 1, kinetics,
                     [&](auto kernel, auto) {
    cudaFuncAttributes attr;
    cudaError_t err = set_smem<decltype(kernel), T>(kernel);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, kernel, kThreads, kSmem<T>);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(kSmem<T> + attr.sharedSizeBytes);
    return 0;
  });
}

}  // namespace

// c0, c1, c2 and torus: the profile operator (null without it); ae, aw, an
// and tissue: the divergence form's face fields and the 0/1 tissue field
// (all null without it; tissue null without an obstacle); work: ten planes
// of the state's shape
#define CRD_FUSED_RKC_ARGS                                                   \
  const void *y, void *y_new, void *ss, void *work, const void *h,          \
      const void *fz, const void *s, const void *mu1_tab, const void *ctab, \
      int s_cap, const void *c0, const void *c1, const void *c2, int torus, \
      const void *ae, const void *aw, const void *an, const void *tissue,   \
      const void *beta, int beta_field, const void *mask, int has_freeze,   \
      int kinetics, int ny, int nx, double rtol, double atol, void *stream
#define CRD_FUSED_RKC_PASS                                                   \
  y, y_new, ss, work, h, fz, s, mu1_tab, ctab, s_cap, c0, c1, c2, torus,    \
      ae, aw, an, tissue, beta, beta_field, mask, has_freeze, kinetics, ny, \
      nx, rtol, atol, stream

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
