// The chunked tile scheme of the port's fused RKC2 step kernels on the
// 2-D operators: K2 (fused_rkc.cu, the periodic grid, WrapGrid) and K9
// (fused_shard_rkc.cu, one shard's block inside the halo the exchange
// filled, HaloGrid). One persistent cooperative launch performs a whole
// step of s Chebyshev stages (integrate/rkc.py): F0 = f(y0),
// Y1 = y0 + (h mu1) F0, for j = 2..s
//   Yj = (1 - mu - nu) y0 + mu Yj-1 + nu Yj-2 + (h mut) f(Yj-1) + (h gt) F0,
// y_new = Ys, F1 = f(y_new), the order-2 error estimate
// est = 0.8 (y0 - y_new) + (0.4 h)(F0 + F1), and partial sums of squared
// WRMS-scaled errors over the points the grid counts (summed by the caller;
// no float atomics, so two launches on the same input give bitwise-equal
// results).
//
// The stage count s, h, the freeze scalar and the coefficient tables live
// on the device: the kernel reads s and indexes mu1[s] and ctab[s][j]
// itself, so the host never learns s. An s outside [2, s_cap] is refused
// by NaN partial sums, which the adaptive loop rejects, and y is kept.
//
// The s + 1 RHS evaluations (F0 with Y1, the s - 1 stages, F1) run in
// chunks of at most kRkcChunk = D, split evenly (chunk c of C =
// ceil((s+1)/D) takes evaluations [c (s+1) / C, (c+1) (s+1) / C);
// ops/fused_rkc.py::chunk_schedule). A chunk is a pass over 32x32 tiles
// whose regions carry a halo of the chunk's own evaluations, one ring an
// evaluation, so a step with s + 1 <= D is one pass, and the halo never
// grows with s. Between chunks, each tile's Yj-1 and Yj-2 (and, after the
// first, F0) go through device memory (`work`, ten planes of the grid's
// layout: F0 and two pairs in turns, so that a chunk reads its
// neighbours' pair while it writes its own), and the grid waits at a
// barrier. Shared memory holds y0, F0 and the stencil's plane (Yj-1's u,
// two buffers, so one block barrier an evaluation) on the D-ring region,
// sized for D whatever s; the recurrence's pointwise values (Yj-2 and
// Yj-1's v) stay in the registers of the point's thread under a fixed map
// of threads onto the region (tile_slots.cuh). An evaluation runs at every
// point of the rows it needs, the columns whose values no longer matter
// included, so that whole warps skip only the rows outside. ProfileRhs's
// coefficients (the three profiles of the region's columns, beta and live
// of its rows) are staged in shared memory once a tile; other functors
// read their own. Each point's arithmetic
// follows the plain versions (ops/fused_rkc.py::rkc_stages_reference)
// operation for operation, wherever it is computed, and the library is
// built with -fmad=false. The right-hand side at a point is a functor the
// kernel template takes: ProfileRhs, or DivformRhs (K2's divergence
// branch), each over the kinetics family.
//
// Where the tiles lie is the grid policy's (ChunkOrigin<Grid>):
// - WrapGrid (K2): the tiles cover the grid in every chunk; a region wraps
//   only where it leaves the grid, any number of times on grids smaller
//   than the halo, and a tile inside the grid takes code without the wrap.
// - HaloGrid (K9): the exchange filled P >= s + 1 rings around the block,
//   so the block's whole cone of dependence for the step lies in the
//   buffer and no exchange is needed between chunks. The tiles of chunk c
//   cover the block grown by the evaluations still to come after it,
//   G_c = s + 1 - e1 rings (0 in the last chunk); a chunk of n
//   evaluations reads its tiles' regions n rings out, G_c + n = G_{c-1}
//   rings around the block: exactly what the chunk before wrote. The
//   values on the outer rings go wrong one ring an evaluation from the
//   buffer's edge inwards and never reach the block, which lies P rings
//   in (ops/fused_shard_rkc.py::extent_rings, and its test). Indices past
//   the buffer (the last tiles' regions) clamp; a region inside the buffer
//   takes code without the clamp. Mirror-pad cells of an uneven mesh step
//   like their sources and stay out of the sums; only the block of y_new
//   is written.
//
// The partial sums are those of the one-pass kernels these replaced, bit
// for bit, so that a run's error sums, and with them its accepted and
// rejected steps, are theirs: rkc2's f32 error estimate sits at the
// rounding floor between waves, where the order of a sum decides steps.
// The last chunk stages a tile's squared errors in shared memory; each
// sum tile (plan.sum_tx x plan.sum_ty, dividing the 32x32 tile: the
// compute tile itself for K2, ops/fused_rkc.py::tile_plan's for K9) is
// added as kRkcThreads threads added it there: thread t the points t,
// t + kRkcThreads, ... of the sum tile, u then v, then the block's
// warp-shuffle tree and its warps in order.
//
// A structured forcing (K2: Stim = StimTable, rhs_common.cuh;
// pallas_rkc.py:434-468, 517-551, 715-735) adds stimulus j's
// (amps[j][a] * rows[j][r]) * cols[j][c] to evaluation e's right-hand
// side at the point of row and column indices (r, c) (the wrapped ones on
// a region's rings). a is the amplitude column of the step's evaluation e,
// whichever chunk runs it: the one column of a table whose stimuli are all
// segment-gated (constant over the step), else the JAX package's stage
// time index of that evaluation (ops/fused_rkc.py::static_stage_tables
// with_times: 0 for F0, e + 1 for f(Y_e) and for F1). Stim = NoStim
// compiles it out.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "box3d.cuh"
#include "rhs_common.cuh"
#include "tile_slots.cuh"

namespace crd {

constexpr int kRkcMaxStages = 23;    // ops/fused_rkc.py S_MAX_KERNEL
constexpr int kRkcThreads = 512;     // ops/fused_rkc.py CHUNK_THREADS
constexpr int kRkcTile = 32;         // ops/fused_rkc.py CHUNK_TILE
constexpr int kRkcChunk = 6;         // ops/fused_rkc.py CHUNK
using RkcRegion = SlotRegion<kRkcTile + 2 * kRkcChunk,
                             kRkcTile + 2 * kRkcChunk, kRkcThreads>;
// shared: y0 and F0, two variables each, and Yj-1's u twice, each plane
// guarded for the stencil (tile_slots.cuh); then the profile operator's
// coefficients of the region's columns (c0, c1, c2) and rows (beta, live)
constexpr int kRkcPlanes = 6;
constexpr int kRkcCoeffs = 3 * RkcRegion::kW + 2 * RkcRegion::kR;

// f32: two blocks an SM (at most 64 registers); f64: one
template <typename T>
constexpr int kRkcMinBlocks = sizeof(T) == 4 ? 2 : 1;

template <typename T>
constexpr size_t kRkcSmem =
    static_cast<size_t>(kRkcPlanes * RkcRegion::kStride + kRkcCoeffs)
    * sizeof(T);

// The right-hand side is the profile operator's: its coefficients are a
// function of the column (c0, c1, c2) and of the row (beta, live), staged
// in shared memory once a tile
template <class Rhs>
struct IsProfileRhs : std::false_type {};
template <int Kin, typename T>
struct IsProfileRhs<ProfileRhs<Kin, T>> : std::true_type {};

// The launch's shape: ny x nx the extent of the last chunk's tiles (the
// grid, or the shard's block); the partial sums' tiles, sum_tiles_x a row
// of them, n_sums in all.
struct RkcPlan {
  int ny;
  int nx;
  int sum_tx;
  int sum_ty;
  int sum_tiles_x;
  int n_sums;
};

// The most tiles a chunk of a step on a shard's nyl x nxl block has, over
// the stage counts 2 .. s_cap: the cooperative launch's block count
// (extent_rings: the first chunk's tiles cover the block grown by the
// evaluations after it).
inline int halo_max_tiles(int s_cap, int nyl, int nxl) {
  int most = 0;
  for (int s = 2; s <= s_cap; ++s) {
    const int n = s + 1;
    const int chunks = (n + kRkcChunk - 1) / kRkcChunk;
    const int rings = n - n / chunks;
    const int tiles = ((nyl + 2 * rings + kRkcTile - 1) / kRkcTile)
                      * ((nxl + 2 * rings + kRkcTile - 1) / kRkcTile);
    if (tiles > most) most = tiles;
  }
  return most;
}

// The rings beyond the plan's extent that a chunk ending at evaluation e1
// of n_evals must cover: none on the periodic grid; on a shard the
// evaluations still to come (ops/fused_shard_rkc.py::extent_rings).
template <class Grid>
__device__ __forceinline__ int extent_rings(int n_evals, int e1) {
  return std::is_same<Grid, HaloGrid>::value ? n_evals - e1 : 0;
}

// A chunk tile's region: the tile whose first point is (gy0, gx0) (the
// plan's coordinates) with kRkcChunk rings. row<Inner>(ly) and
// col<Inner>(lx) are the indices of local row ly and column lx into the
// RHS's row and column constants, at<Inner>(ly, lx) the offset into a
// plane of the state and of `work`; in_grid(ly, lx) whether the point is
// one of the chunk's extent (its values are handed on; in the last chunk,
// its y_new is written), counted(ly, lx) whether it enters the sums.
template <class Grid>
struct ChunkOrigin;

// The periodic grid: TileOrigin, the wrap written as loops
template <>
struct ChunkOrigin<WrapGrid> : TileOrigin {
  __device__ __forceinline__ ChunkOrigin(const WrapGrid& g, int gy0, int gx0,
                                         int)
      : TileOrigin(gy0, gx0, kRkcChunk, RkcRegion::kW, RkcRegion::kR, g.ny,
                   g.nx) {}
  __device__ __forceinline__ bool counted(int, int) const { return true; }
};

// One shard's block inside its halo: indices into the halo-padded buffer
// and constants, clamped where a region leaves the buffer; the extent the
// block grown by `rings`.
template <>
struct ChunkOrigin<HaloGrid> {
  HaloGrid g;
  int y0;       // the region's first row and column, buffer indices
  int x0;
  int ey;       // the extent's end row and column, buffer indices
  int ex;
  bool inner;   // the region lies inside the buffer: nothing clamps

  __device__ __forceinline__ ChunkOrigin(const HaloGrid& g_, int gy0,
                                         int gx0, int rings)
      : g(g_), y0(gy0 - kRkcChunk + g_.halo), x0(gx0 - kRkcChunk + g_.halo),
        ey(g_.halo + g_.nyl + rings), ex(g_.halo + g_.nxl + rings),
        inner(y0 >= 0 && x0 >= 0 && y0 + RkcRegion::kR <= g_.nyl + 2 * g_.halo
              && x0 + RkcRegion::kW <= g_.nxl + 2 * g_.halo) {}

  template <bool Inner>
  __device__ __forceinline__ int row(int ly) const {
    const int r = y0 + ly;
    return Inner ? r : min(max(r, 0), g.nyl + 2 * g.halo - 1);
  }
  template <bool Inner>
  __device__ __forceinline__ int col(int lx) const {
    const int c = x0 + lx;
    return Inner ? c : min(max(c, 0), g.nxl + 2 * g.halo - 1);
  }
  template <bool Inner>
  __device__ __forceinline__ size_t at(int ly, int lx) const {
    return g.field(row<Inner>(ly), col<Inner>(lx));
  }
  __device__ __forceinline__ bool in_grid(int ly, int lx) const {
    return y0 + ly < ey && x0 + lx < ex;
  }
  __device__ __forceinline__ bool counted(int ly, int lx) const {
    return g.counted(y0 + ly - g.halo, x0 + lx - g.halo);
  }
};

// One partial sum of a block: warp shuffles, then the warps in order
// (store_block_sum's order), into *out.
template <typename T>
__device__ __forceinline__ void store_tile_sum(T acc, T* warp_sums, T* out) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int i = 0; i < kRkcThreads / 32; ++i) total += warp_sums[i];
    *out = total;
  }
  __syncthreads();
}

// The functor: rhs.at(fz, su, v, p, W, r, c, du, dv) writes ydot at local
// point p of a region with row stride W holding variable 0 in su, v the
// point's variable 1, r and c its row and column indices. Evaluation e's
// forcing reads amplitude column rhs_common.cuh::rkc_amp_column(e).
template <class Rhs, class Grid, typename T, class Stim>
__global__ void __launch_bounds__(kRkcThreads, (kRkcMinBlocks<T>))
    fused_rkc_chunk_kernel(const T* __restrict__ y, T* __restrict__ y_new,
                           T* __restrict__ ss, T* work,
                           const T* __restrict__ h_ptr,
                           const T* __restrict__ fz_ptr,
                           const int* __restrict__ s_ptr,
                           const T* __restrict__ mu1_tab,
                           const T* __restrict__ ctab, int s_cap, Rhs rhs,
                           Grid grid, RkcPlan plan, T rtol, T atol,
                           Stim stim) {
  using Reg = RkcRegion;
  using Origin = ChunkOrigin<Grid>;
  constexpr int W = Reg::kW;
  constexpr int S = Reg::kSlots;
  constexpr int PS = Reg::kStride;
  constexpr int kTile = kRkcTile;
  constexpr int kChunk = kRkcChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kRkcThreads / 32];
  __shared__ T e2[2][kTile * kTile];  // a tile's squared scaled errors
  T* const y0u = reinterpret_cast<T*>(smem_raw) + Reg::kGuard;
  T* const y0v = y0u + PS;            // y0u: the step's start
  T* const f0u = y0u + 2 * PS;        // F0 = f(y0)
  T* const f0v = y0u + 3 * PS;
  T* const cu0 = y0u + 4 * PS;        // Yj-1's u, in turns
  T* const cu1 = y0u + 5 * PS;
  // ProfileRhs: c0, c1, c2 of the region's columns, beta and live of its
  // rows
  T* const colc = y0u - Reg::kGuard + kRkcPlanes * PS;
  T* const rowc = colc + 3 * W;
  constexpr bool kProfile = IsProfileRhs<Rhs>::value;
  cg::grid_group gridg = cg::this_grid();

  // the tiles over the plan's extent grown by `rings`: their count, a row
  // of them in tiles_x
  const auto tiles = [&](int rings, int& tiles_x) {
    tiles_x = (plan.nx + 2 * rings + kTile - 1) / kTile;
    return tiles_x * ((plan.ny + 2 * rings + kTile - 1) / kTile);
  };
  const int s = *s_ptr;
  const size_t plane = grid.plane();
  if (s < 2 || s > s_cap) {
    // no table row for this stage count: keep y, poison the error sums
    int tiles_x;
    const int n_tiles = tiles(0, tiles_x);
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int ty0 = t / tiles_x;
      const Origin o(grid, ty0 * kTile, (t - ty0 * tiles_x) * kTile, 0);
#pragma unroll
      for (int m = 0; m < S; ++m) {
        const int p = Reg::point(m);
        if (!Reg::valid(m) || !Reg::inside(p, kChunk)) continue;
        const int ly = Reg::row(p), lx = Reg::col(p);
        if (!o.in_grid(ly, lx)) continue;
        const size_t g = o.template at<false>(ly, lx);
        y_new[g] = y[g];
        y_new[plane + g] = y[plane + g];
      }
    }
    if (threadIdx.x == 0)
      for (int i = blockIdx.x; i < plan.n_sums; i += gridDim.x)
        ss[i] = quiet_nan<T>();
    return;
  }

  const T h = *h_ptr;
  const T fz = *fz_ptr;
  const T hmu1 = h * mu1_tab[s];
  const T h04 = T(0.4) * h;
  const T* const row = ctab + static_cast<size_t>(s)
                                  * (kRkcMaxStages + 1) * 4;
  const int n_evals = s + 1;
  const int n_chunks = (n_evals + kChunk - 1) / kChunk;
  T* const f0buf = work;              // F0 on the grid, after chunk 0
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) gridg.sync();
    const int e0 = c * n_evals / n_chunks;
    const int e1 = (c + 1) * n_evals / n_chunks;
    const int off = kChunk - (e1 - e0);   // the region's unused rings
    const int rings = extent_rings<Grid>(n_evals, e1);
    int tiles_x;
    const int n_tiles = tiles(rings, tiles_x);
    // the pairs (Ye, Ye-1) a chunk hands on: u, v, u, v in turns
    const T* const rd = work + (2 + 4 * ((c + 1) & 1)) * plane;
    T* const wr = work + (2 + 4 * (c & 1)) * plane;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int ty0 = t / tiles_x, tx0 = t - ty0 * tiles_x;
      const Origin o(grid, ty0 * kTile - rings, tx0 * kTile - rings, rings);
      // the chunk on one tile; kIn: its region lies inside the grid
      const auto chunk = [&](auto inner) {
        constexpr bool kIn = decltype(inner)::value;
        // f(u, v) of evaluation e at local point p (row ly, column lx),
        // u read from the plane su at p and its neighbours: ProfileRhs on
        // the staged coefficients (ProfileRhs::at's operations, at_point),
        // any other functor on its own reads; with a forcing, its value at
        // the point added
        const auto f = [&](int e, const T* su, T v, int p, int ly, int lx,
                           T& du, T& dv) {
          if constexpr (Stim::kOn) {
            const int r = o.template row<kIn>(ly);
            const int c = o.template col<kIn>(lx);
            T gu, gv;
            stim.at(rkc_amp_column(e, stim.n_cols), r, c, gu, gv);
            if constexpr (kProfile)
              rhs.at_point({colc[lx], colc[W + lx], colc[2 * W + lx],
                            rowc[ly], rowc[Reg::kR + ly]},
                           nullptr, su, v, p, W, gu, gv, du, dv);
            else
              rhs.at(fz, su, v, p, W, r, c, gu, gv, du, dv);
          } else if constexpr (kProfile) {
            rhs.at_point({colc[lx], colc[W + lx], colc[2 * W + lx],
                          rowc[ly], rowc[Reg::kR + ly]},
                         nullptr, su, v, p, W, du, dv);
          } else {
            rhs.at(fz, su, v, p, W, o.template row<kIn>(ly),
                   o.template col<kIn>(lx), du, dv);
          }
        };
        if constexpr (kProfile) {
          const int i = threadIdx.x;
          if (i < W) {
            const int c = rhs.k.torus ? o.template col<kIn>(i) : 0;
            colc[i] = rhs.k.c0[c];
            colc[W + i] = rhs.k.c1[c];
            colc[2 * W + i] = rhs.k.c2[c];
          } else if (i >= 64 && i < 64 + Reg::kR) {
            const int r = o.template row<kIn>(i - 64);
            rowc[i - 64] = beta_at(rhs.k, r);
            rowc[Reg::kR + i - 64] =
                rhs.k.has_freeze ? live_at(rhs.k, fz, r) : T(1);
          }
        }
        T ycv[S], ypu[S], ypv[S];     // Yj-1's v, Yj-2 at the thread's points
#pragma unroll
        for (int m = 0; m < S; ++m) {
          ycv[m] = ypu[m] = ypv[m] = T(0);
          const int p = Reg::point(m);
          if (!Reg::valid(m) || !Reg::inside(p, off)) continue;
          const size_t g = o.template at<kIn>(Reg::row(p), Reg::col(p));
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
        // evaluation e is right on the points d = off + e - e0 + 1 rings
        // in and more, and runs on the rows of those points, every column
        // (the values further out unused): whole warps skip the rows
        // outside, a lane's skipped point being one no later evaluation of
        // the chunk needs
        bool second = false;          // Yj-1's u in cu1, not cu0
        for (int e = e0; e < e1; ++e) {
          T* const cur = second ? cu1 : cu0;
          T* const nxt = second ? cu0 : cu1;
          const int d = off + e - e0 + 1;
          const auto needed = [&](int m) {
            const int ly = Reg::row(Reg::point(m));
            return Reg::valid(m) && ly >= d && ly < Reg::kR - d;
          };
          if (e == 0) {
            // F0 and Y1 = y0 + (h mu1) F0
#pragma unroll
            for (int m = 0; m < S; ++m) {
              if (!needed(m)) continue;
              const int p = Reg::point(m);
              const int ly = Reg::row(p), lx = Reg::col(p);
              const T u0 = y0u[p], v0 = y0v[p];
              T du, dv;
              f(e, y0u, v0, p, ly, lx, du, dv);
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
              if (!needed(m)) continue;
              const int p = Reg::point(m);
              const int ly = Reg::row(p), lx = Reg::col(p);
              T fu, fv;
              f(e, cur, ycv[m], p, ly, lx, fu, fv);
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
              f(e, cur, ycv[m], p, ly, lx, f1u, f1v);
              const T yu = cur[p], yv = ycv[m];
              const size_t g = o.template at<kIn>(ly, lx);
              y_new[g] = yu;
              y_new[plane + g] = yv;
              if (!o.counted(ly, lx)) {   // a pad cell of a padded mesh
                e2[0][q] = T(0);
                e2[1][q] = T(0);
                continue;
              }
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
          // the sum tiles of this tile (the extent is the plan's here), each
          // in the one-pass kernels' order: thread t adds the points t,
          // t + kRkcThreads, ... of the sum tile, u then v
          const int gy0 = ty0 * kTile, gx0 = tx0 * kTile;
          const int sx = plan.sum_tx, sy = plan.sum_ty;
          for (int y1 = 0; y1 < kTile && gy0 + y1 < plan.ny; y1 += sy) {
            for (int x1 = 0; x1 < kTile && gx0 + x1 < plan.nx; x1 += sx) {
              T acc = T(0);
              for (int q = threadIdx.x; q < sx * sy; q += kRkcThreads) {
                const int qy = q / sx;
                const int i = (y1 + qy) * kTile + x1 + q - qy * sx;
                acc = acc + e2[0][i];
                acc = acc + e2[1][i];
              }
              store_tile_sum(acc, warp_sums,
                             ss + ((gy0 + y1) / sy) * plan.sum_tiles_x
                                 + (gx0 + x1) / sx);
            }
          }
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
          const size_t g = o.template at<kIn>(ly, lx);
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

template <typename T, typename Kernel>
cudaError_t rkc_chunk_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kRkcSmem<T>));
}

// One step of fused_rkc_chunk_kernel<Rhs, Grid, T, Stim> on `stream`: a
// cooperative launch of as many blocks as stay resident, at most
// max_tiles (the most tiles a chunk has); stim: the structured forcing
// (StimTable) or NoStim; returns the CUDA error code (0 on success),
// checked right after the launch.
template <class Rhs, class Grid, typename T, class Stim = NoStim>
int launch_rkc_chunk(Rhs rhs, Grid grid, RkcPlan plan, int max_tiles,
                     const void* y, void* y_new, void* ss, void* work,
                     const void* h, const void* fz, const void* s,
                     const void* mu1_tab, const void* ctab, int s_cap,
                     double rtol, double atol, void* stream,
                     Stim stim = Stim{}) {
  if (s_cap < 2 || s_cap > kRkcMaxStages || plan.ny < 1 || plan.nx < 1
      || plan.sum_tx < 1 || plan.sum_ty < 1 || kRkcTile % plan.sum_tx != 0
      || kRkcTile % plan.sum_ty != 0 || max_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = &fused_rkc_chunk_kernel<Rhs, Grid, T, Stim>;
  const cudaError_t err = rkc_chunk_smem<T>(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  void* args[] = {&y_arg, &ynew_arg, &ss_arg, &work_arg, &h_arg, &fz_arg,
                  &s_arg, &mu1_arg, &ctab_arg, &s_cap, &rhs, &grid, &plan,
                  &rtol_arg, &atol_arg, &stim};
  int n_blocks = 0;
  return launch_cooperative(kernel,
                            static_cast<size_t>(max_tiles) * kRkcThreads,
                            max_tiles, &n_blocks, args, stream, kRkcSmem<T>,
                            kRkcThreads);
}

// out[0] the resident blocks an SM, out[1] the registers a thread, out[2]
// the shared bytes (dynamic and static) a block of the unforced
// fused_rkc_chunk_kernel<Rhs, Grid, T>; returns the CUDA error code.
template <class Rhs, class Grid, typename T>
int rkc_chunk_info(int* out) {
  auto kernel = &fused_rkc_chunk_kernel<Rhs, Grid, T, NoStim>;
  cudaFuncAttributes attr;
  cudaError_t err = rkc_chunk_smem<T>(kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, kRkcThreads, kRkcSmem<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(kRkcSmem<T> + attr.sharedSizeBytes);
  return 0;
}

// The chunked scheme for the families of any shape (FamilyRhs: the
// NEW_FAMILIES, unforced; K2 on the periodic grid, K9 on a shard's block
// in its halo, the grid policy a template parameter as the base kernel's):
// the chunks, tiles (on a shard, each chunk's over the block grown by the
// evaluations still to come), slots, grid barriers and partial sums of
// fused_rkc_chunk_kernel, with every variable of y0 and F0 in shared
// memory, every variable of Yj-1 and Yj-2 in the registers of the point's
// thread, and two shared planes of Yj-1 for each diffusing variable, which
// the stencil reads; `work` holds F0 and the two (Yj-1, Yj-2) sets in
// turns, every variable each (5 NV planes of the grid's or the buffer's
// layout). The squared errors are added variable by variable, a
// mirror-pad cell's as +0.0, each sum tile in the base kernel's order.
template <int Kin>
struct RkcFamilyPlan {
  static constexpr int kNv = Family<Kin>::kNv;
  static constexpr int kNd = Family<Kin>::kNd;
  // y0 and F0 of every variable, Yj-1's diffusing variables twice
  static constexpr int kPlanes = 2 * kNv + 2 * kNd;
  template <typename T>
  static constexpr size_t smem() {
    return static_cast<size_t>(kPlanes * RkcRegion::kStride + kRkcCoeffs)
           * sizeof(T);
  }
};

template <int Kin, class Grid, typename T>
__global__ void __launch_bounds__(kRkcThreads, (kRkcMinBlocks<T>))
    fused_rkc_chunk_n_kernel(const T* __restrict__ y, T* __restrict__ y_new,
                             T* __restrict__ ss, T* work,
                             const T* __restrict__ h_ptr,
                             const T* __restrict__ fz_ptr,
                             const int* __restrict__ s_ptr,
                             const T* __restrict__ mu1_tab,
                             const T* __restrict__ ctab, int s_cap,
                             FamilyRhs<Kin, T> rhs, Grid grid,
                             RkcPlan plan, T rtol, T atol) {
  using Fam = Family<Kin>;
  using Reg = RkcRegion;
  using Origin = ChunkOrigin<Grid>;
  // a shard's block: each chunk's tiles over its own extent, the partial
  // sums over the plan's sum tiles; the periodic grid's chunks share the
  // plan's tiles, each its own sum tile
  constexpr bool kShard = std::is_same<Grid, HaloGrid>::value;
  constexpr int NV = Fam::kNv;
  constexpr int ND = Fam::kNd;
  constexpr int W = Reg::kW;
  constexpr int S = Reg::kSlots;
  constexpr int PS = Reg::kStride;
  constexpr int kTile = kRkcTile;
  constexpr int kChunk = kRkcChunk;
  constexpr int kPlanes = RkcFamilyPlan<Kin>::kPlanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kRkcThreads / 32];
  __shared__ T e2[NV][kTile * kTile];  // a tile's squared scaled errors
  T* const base = reinterpret_cast<T*>(smem_raw) + Reg::kGuard;
  T* const y0s = base;                 // variable v at y0s + v PS
  T* const f0s = base + NV * PS;       // F0 = f(y0)
  // Yj-1's diffusing variable i in turn t (0, 1)
  const auto ycs = [&](int t, int i) {
    return base + (2 * NV + t * ND + i) * PS;
  };
  T* const colc = base - Reg::kGuard + kPlanes * PS;
  T* const rowc = colc + 3 * W;
  cg::grid_group gridg = cg::this_grid();

  // the tiles over the plan's extent grown by `rings`: their count, a row
  // of them in tiles_x
  const auto tiles = [&](int rings, int& tiles_x) {
    tiles_x = (plan.nx + 2 * rings + kTile - 1) / kTile;
    return tiles_x * ((plan.ny + 2 * rings + kTile - 1) / kTile);
  };
  const int s = *s_ptr;
  const size_t plane = grid.plane();
  if (s < 2 || s > s_cap) {
    // no table row for this stage count: keep y, poison the error sums
    int tiles_x;
    const int n_tiles = tiles(0, tiles_x);
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int ty0 = t / tiles_x;
      const Origin o(grid, ty0 * kTile, (t - ty0 * tiles_x) * kTile, 0);
#pragma unroll
      for (int m = 0; m < S; ++m) {
        const int p = Reg::point(m);
        if (!Reg::valid(m) || !Reg::inside(p, kChunk)) continue;
        const int ly = Reg::row(p), lx = Reg::col(p);
        if (!o.in_grid(ly, lx)) continue;
        const size_t g = o.template at<false>(ly, lx);
#pragma unroll
        for (int v = 0; v < NV; ++v) y_new[v * plane + g] = y[v * plane + g];
      }
    }
    if (threadIdx.x == 0)
      for (int i = blockIdx.x; i < plan.n_sums; i += gridDim.x)
        ss[i] = quiet_nan<T>();
    return;
  }

  const T h = *h_ptr;
  const T fz = *fz_ptr;
  const T hmu1 = h * mu1_tab[s];
  const T h04 = T(0.4) * h;
  const T* const row = ctab + static_cast<size_t>(s)
                                  * (kRkcMaxStages + 1) * 4;
  const int n_evals = s + 1;
  const int n_chunks = (n_evals + kChunk - 1) / kChunk;
  T* const f0buf = work;               // F0 on the grid, after chunk 0
  int tiles_x;
  int n_tiles = tiles(0, tiles_x);
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) gridg.sync();
    const int e0 = c * n_evals / n_chunks;
    const int e1 = (c + 1) * n_evals / n_chunks;
    const int off = kChunk - (e1 - e0);   // the region's unused rings
    const int rings = extent_rings<Grid>(n_evals, e1);
    if constexpr (kShard) n_tiles = tiles(rings, tiles_x);
    // the sets (Ye, Ye-1) a chunk hands on, every variable each, in turns
    const T* const rd = work + (NV + 2 * NV * ((c + 1) & 1)) * plane;
    T* const wr = work + (NV + 2 * NV * (c & 1)) * plane;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int ty0 = t / tiles_x, tx0 = t - ty0 * tiles_x;
      const Origin o(grid, ty0 * kTile - rings, tx0 * kTile - rings, rings);
      const auto chunk = [&](auto inner) {
        constexpr bool kIn = decltype(inner)::value;
        // f(x) at local point p (row ly, column lx) on the staged
        // coefficients, the diffusing variables read from turn tt's planes
        // (tt < 0: y0's)
        const auto f = [&](int tt, const T* x, int p, int ly, int lx,
                           T* dy) {
          const T* planes[ND];
#pragma unroll
          for (int i = 0; i < ND; ++i)
            planes[i] = tt < 0 ? y0s + Fam::var(i) * PS : ycs(tt, i);
          rhs.at_point({colc[lx], colc[W + lx], colc[2 * W + lx], rowc[ly],
                        rowc[Reg::kR + ly]},
                       planes, x, p, W, dy);
        };
        {
          const int i = threadIdx.x;
          if (i < W) {
            const int cc = rhs.k.torus ? o.template col<kIn>(i) : 0;
            colc[i] = rhs.k.c0[cc];
            colc[W + i] = rhs.k.c1[cc];
            colc[2 * W + i] = rhs.k.c2[cc];
          } else if (i >= 64 && i < 64 + Reg::kR) {
            const int r = o.template row<kIn>(i - 64);
            rowc[i - 64] = beta_at(rhs.k, r);
            rowc[Reg::kR + i - 64] =
                rhs.k.has_freeze ? live_at(rhs.k, fz, r) : T(1);
          }
        }
        T yc[NV][S], yp[NV][S];       // Yj-1, Yj-2 at the thread's points
#pragma unroll
        for (int m = 0; m < S; ++m) {
#pragma unroll
          for (int v = 0; v < NV; ++v) yc[v][m] = yp[v][m] = T(0);
          const int p = Reg::point(m);
          if (!Reg::valid(m) || !Reg::inside(p, off)) continue;
          const size_t g = o.template at<kIn>(Reg::row(p), Reg::col(p));
#pragma unroll
          for (int v = 0; v < NV; ++v) y0s[v * PS + p] = y[v * plane + g];
          if (c == 0) continue;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            f0s[v * PS + p] = f0buf[v * plane + g];
            yc[v][m] = rd[v * plane + g];
            yp[v][m] = rd[(NV + v) * plane + g];
          }
#pragma unroll
          for (int i = 0; i < ND; ++i) ycs(0, i)[p] = yc[Fam::var(i)][m];
        }
        __syncthreads();
        // evaluation e is right on the points d = off + e - e0 + 1 rings
        // in and more, and runs on the rows of those points
        int turn = 0;                 // Yj-1's diffusing planes: turn
        for (int e = e0; e < e1; ++e) {
          const int d = off + e - e0 + 1;
          const auto needed = [&](int m) {
            const int ly = Reg::row(Reg::point(m));
            return Reg::valid(m) && ly >= d && ly < Reg::kR - d;
          };
          if (e == 0) {
            // F0 and Y1 = y0 + (h mu1) F0
#pragma unroll
            for (int m = 0; m < S; ++m) {
              if (!needed(m)) continue;
              const int p = Reg::point(m);
              T x[NV], dy[NV];
#pragma unroll
              for (int v = 0; v < NV; ++v) x[v] = y0s[v * PS + p];
              f(-1, x, p, Reg::row(p), Reg::col(p), dy);
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                f0s[v * PS + p] = dy[v];
                yc[v][m] = x[v] + hmu1 * dy[v];
                yp[v][m] = x[v];
              }
#pragma unroll
              for (int i = 0; i < ND; ++i)
                ycs(1 - turn, i)[p] = yc[Fam::var(i)][m];
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
              if (!needed(m)) continue;
              const int p = Reg::point(m);
              T x[NV], fy[NV];
#pragma unroll
              for (int v = 0; v < NV; ++v) x[v] = yc[v][m];
              f(turn, x, p, Reg::row(p), Reg::col(p), fy);
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                yc[v][m] = cy0 * y0s[v * PS + p] + mu * x[v] + nu * yp[v][m]
                           + hmut * fy[v] + hgt * f0s[v * PS + p];
                yp[v][m] = x[v];
              }
#pragma unroll
              for (int i = 0; i < ND; ++i)
                ycs(1 - turn, i)[p] = yc[Fam::var(i)][m];
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
#pragma unroll
                for (int v = 0; v < NV; ++v) e2[v][q] = T(0);
                continue;
              }
              T x[NV], f1[NV];
#pragma unroll
              for (int v = 0; v < NV; ++v) x[v] = yc[v][m];
              f(turn, x, p, ly, lx, f1);
              const size_t g = o.template at<kIn>(ly, lx);
              const bool counted = o.counted(ly, lx);   // not a pad cell
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                const T x0 = y0s[v * PS + p];
                y_new[v * plane + g] = x[v];
                const T est = T(0.8) * (x0 - x[v])
                              + h04 * (f0s[v * PS + p] + f1[v]);
                const T w = est * (T(1) / (rtol * fabs(x0) + atol));
                e2[v][q] = counted ? w * w : T(0);
              }
            }
          }
          turn = 1 - turn;
          __syncthreads();
        }
        if (e1 == n_evals) {
          // the sum tiles of this tile (the extent is the plan's here), each
          // in the one-pass kernels' order: thread t adds the points t,
          // t + kRkcThreads, ... of the sum tile, variable by variable
          if constexpr (!kShard) {
            // the tile is its own sum tile
            T acc = T(0);
            for (int q = threadIdx.x; q < kTile * kTile; q += kRkcThreads)
#pragma unroll
              for (int v = 0; v < NV; ++v) acc = acc + e2[v][q];
            store_tile_sum(acc, warp_sums,
                           ss + ty0 * plan.sum_tiles_x + tx0);
            return;
          }
          const int gy0 = ty0 * kTile, gx0 = tx0 * kTile;
          const int sx = plan.sum_tx, sy = plan.sum_ty;
          for (int y1 = 0; y1 < kTile && gy0 + y1 < plan.ny; y1 += sy) {
            for (int x1 = 0; x1 < kTile && gx0 + x1 < plan.nx; x1 += sx) {
              T acc = T(0);
              for (int q = threadIdx.x; q < sx * sy; q += kRkcThreads) {
                const int qy = q / sx;
                const int i = (y1 + qy) * kTile + x1 + q - qy * sx;
#pragma unroll
                for (int v = 0; v < NV; ++v) acc = acc + e2[v][i];
              }
              store_tile_sum(acc, warp_sums,
                             ss + ((gy0 + y1) / sy) * plan.sum_tiles_x
                                 + (gx0 + x1) / sx);
            }
          }
          return;
        }
        // hand the tile's (Ye1, Ye1-1), and after chunk 0 F0, to the next
        // chunk; each thread reads only its own points here
#pragma unroll
        for (int m = 0; m < S; ++m) {
          const int p = Reg::point(m);
          if (!Reg::valid(m) || !Reg::inside(p, kChunk)) continue;
          const int ly = Reg::row(p), lx = Reg::col(p);
          if (!o.in_grid(ly, lx)) continue;
          const size_t g = o.template at<kIn>(ly, lx);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            wr[v * plane + g] = yc[v][m];
            wr[(NV + v) * plane + g] = yp[v][m];
            if (c == 0) f0buf[v * plane + g] = f0s[v * PS + p];
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

// One step of fused_rkc_chunk_n_kernel<Kin, Grid, T> on `stream`, a
// cooperative launch as launch_rkc_chunk's; returns the CUDA error code.
template <int Kin, class Grid, typename T>
int launch_rkc_chunk_n(FamilyRhs<Kin, T> rhs, Grid grid, RkcPlan plan,
                       int max_tiles, const void* y, void* y_new, void* ss,
                       void* work, const void* h, const void* fz,
                       const void* s, const void* mu1_tab, const void* ctab,
                       int s_cap, double rtol, double atol, void* stream) {
  // the periodic grid's sum tiles are its tiles
  const bool own_sums = plan.sum_tx == kRkcTile && plan.sum_ty == kRkcTile;
  if (s_cap < 2 || s_cap > kRkcMaxStages || plan.ny < 1 || plan.nx < 1
      || plan.sum_tx < 1 || plan.sum_ty < 1 || kRkcTile % plan.sum_tx != 0
      || kRkcTile % plan.sum_ty != 0 || max_tiles < 1
      || (!std::is_same<Grid, HaloGrid>::value && !own_sums))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = &fused_rkc_chunk_n_kernel<Kin, Grid, T>;
  constexpr size_t smem = RkcFamilyPlan<Kin>::template smem<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
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
  void* args[] = {&y_arg, &ynew_arg, &ss_arg, &work_arg, &h_arg, &fz_arg,
                  &s_arg, &mu1_arg, &ctab_arg, &s_cap, &rhs, &grid, &plan,
                  &rtol_arg, &atol_arg};
  int n_blocks = 0;
  return launch_cooperative(kernel,
                            static_cast<size_t>(max_tiles) * kRkcThreads,
                            max_tiles, &n_blocks, args, stream, smem,
                            kRkcThreads);
}

// rkc_chunk_info of fused_rkc_chunk_n_kernel<Kin, Grid, T>
template <int Kin, class Grid, typename T>
int rkc_chunk_n_info(int* out) {
  auto kernel = &fused_rkc_chunk_n_kernel<Kin, Grid, T>;
  constexpr size_t smem = RkcFamilyPlan<Kin>::template smem<T>();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                        kRkcThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(smem + attr.sharedSizeBytes);
  return 0;
}

}  // namespace crd
