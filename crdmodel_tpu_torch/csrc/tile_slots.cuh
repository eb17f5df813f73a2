// A fixed map of a block's threads onto the points of a tile's region, the
// scheme of the port's register-resident tile kernels: K14 (fused_kstep.cu),
// K2 and K9 (rkc_chunk.cuh), K4, K11, K1 and K8 (erk_slots.cuh) and K10
// (imex_slots.cuh). The region is the tile and its halo, W x R points
// row-major, both compile-time; thread t owns the points p = t + Threads m,
// its slots m = 0 .. kSlots - 1, for the whole launch. A value read only
// at its own point (a stage, the step's start) stays in the owner's
// registers from one evaluation to the next; only what a stencil reads at
// neighbours goes through shared memory. Loops over the slots are unrolled,
// so the per-slot arrays are registers; a slot is computed at every point
// of the region, the rings whose values no longer matter included, so
// that the slots' code has no branches (the values there are never read by
// a point that matters). The region's position on the periodic grid is a
// TileOrigin; its rows and columns wrap only where the region leaves the
// grid, and on grids smaller than the halo as often as the wrap needs; a
// kernel takes a tile inside the grid through code without the wrap.
// SlotOrigin puts a region on a grid policy (rhs_common.cuh): the periodic
// grid (WrapGrid, through TileOrigin) or a shard's block in its halo
// (HaloGrid).

#pragma once

#include <cuda_runtime.h>

#include "rhs_common.cuh"

namespace crd {

template <int W, int R, int Threads>
struct SlotRegion {
  static constexpr int kW = W;
  static constexpr int kR = R;
  static constexpr int kPoints = W * R;
  static constexpr int kSlots = (kPoints + Threads - 1) / Threads;
  // A plane that a stencil reads at every point of the region, rings
  // whose values no longer matter included, carries kGuard points before
  // and after, so that those reads stay inside the buffer: kStride
  // points a plane.
  static constexpr int kGuard = W + 1;
  static constexpr int kStride = kPoints + 2 * kGuard;

  // the local index of this thread's slot m
  static __device__ __forceinline__ int point(int m) {
    return static_cast<int>(threadIdx.x) + Threads * m;
  }
  // slot m holds a point of the region (only the last slot may not)
  static __device__ __forceinline__ bool valid(int m) {
    return (m + 1) * Threads <= kPoints || point(m) < kPoints;
  }
  // local point p lies d or more rings inside the region
  static __device__ __forceinline__ bool inside(int p, int d) {
    const int ly = p / W, lx = p - (p / W) * W;
    return ly >= d && ly < R - d && lx >= d && lx < W - d;
  }
  static __device__ __forceinline__ int row(int p) { return p / W; }
  static __device__ __forceinline__ int col(int p) { return p - (p / W) * W; }
};

// The region of a tile whose first point is (gy0, gx0) with `halo` rings
// on the periodic ny x nx grid, the region w x r points: the wrapped grid
// row and column of local row ly and column lx (indices into the state's
// planes and the RHS's constants), and whether grid point (ly, lx) of the
// tile lies inside the grid.
struct TileOrigin {
  int y0;       // the region's first row and column, unwrapped
  int x0;
  int ny;
  int nx;
  bool inner;   // the region lies inside the grid: no index wraps

  __device__ __forceinline__ TileOrigin(int gy0, int gx0, int halo, int w,
                                        int r, int ny_, int nx_)
      : y0(gy0 - halo), x0(gx0 - halo), ny(ny_), nx(nx_),
        inner(gy0 - halo >= 0 && gy0 - halo + r <= ny_ && gx0 - halo >= 0
              && gx0 - halo + w <= nx_) {}

  // the grid row and column of local row ly and column lx: by addition
  // where the region lies inside the grid (Inner, a tile's compile-time
  // case), else by a wrap written as loops, which no branch is
  // if-converted into: one step where the grid is as large as the region,
  // more only on grids smaller than the halo
  template <bool Inner>
  __device__ __forceinline__ int row(int ly) const {
    int r = y0 + ly;
    if (!Inner) {
      while (r < 0) r += ny;
      while (r >= ny) r -= ny;
    }
    return r;
  }
  template <bool Inner>
  __device__ __forceinline__ int col(int lx) const {
    int c = x0 + lx;
    if (!Inner) {
      while (c < 0) c += nx;
      while (c >= nx) c -= nx;
    }
    return c;
  }
  template <bool Inner>
  __device__ __forceinline__ size_t at(int ly, int lx) const {
    return static_cast<size_t>(row<Inner>(ly)) * nx + col<Inner>(lx);
  }
  // unwrapped: the point is one of the grid's, not a wrapped copy past
  // the grid's last row or column
  __device__ __forceinline__ bool in_grid(int ly, int lx) const {
    return y0 + ly < ny && x0 + lx < nx;
  }
};

// A tile's region on the grid a kernel reads, whose tile starts at (gy0,
// gx0) and whose region, `halo` rings around it, is w x r points: row(ly)
// and col(lx) are the row and column indices of local row ly and column
// lx (into the state's planes and the RHS's constants), by addition where
// the region lies inside (Inner, a tile's compile-time case), else
// wrapped or clamped; ld() the state's row stride and plane() its plane;
// in_block(ly, lx) whether the point is one of the extent the tiles cover
// (its y_new is written), counted(ly, lx) whether it enters the sums.
template <class Grid>
struct SlotOrigin;

// The periodic grid: TileOrigin, the wrap written as loops
template <>
struct SlotOrigin<WrapGrid> : TileOrigin {
  __device__ __forceinline__ SlotOrigin(const WrapGrid& g, int gy0, int gx0,
                                        int halo, int w, int r)
      : TileOrigin(gy0, gx0, halo, w, r, g.ny, g.nx) {}

  __device__ __forceinline__ int ld() const { return nx; }
  __device__ __forceinline__ size_t plane() const {
    return static_cast<size_t>(ny) * nx;
  }
  __device__ __forceinline__ bool in_block(int ly, int lx) const {
    return in_grid(ly, lx);
  }
  __device__ __forceinline__ bool counted(int, int) const { return true; }
};

// One shard's block inside its halo (HaloGrid): the exchange filled halo
// >= n rings, so a full tile's region lies inside the buffer; only the
// partial tiles at the block's last rows and columns reach past it, and
// clamp there as HaloGrid::row and col do (those points feed none that is
// written). Mirror-pad cells step like the others and stay out of the
// sums.
template <>
struct SlotOrigin<HaloGrid> {
  HaloGrid g;
  int y0;       // the region's first row and column, block coordinates
  int x0;
  bool inner;   // the region lies inside the buffer: nothing clamps

  __device__ __forceinline__ SlotOrigin(const HaloGrid& g_, int gy0, int gx0,
                                        int halo, int w, int r)
      : g(g_), y0(gy0 - halo), x0(gx0 - halo),
        inner(gy0 - halo + r <= g_.nyl + g_.halo
              && gx0 - halo + w <= g_.nxl + g_.halo) {}

  template <bool Inner>
  __device__ __forceinline__ int row(int ly) const {
    const int r = y0 + ly + g.halo;
    return Inner ? r : min(r, g.nyl + 2 * g.halo - 1);
  }
  template <bool Inner>
  __device__ __forceinline__ int col(int lx) const {
    const int c = x0 + lx + g.halo;
    return Inner ? c : min(c, g.nxl + 2 * g.halo - 1);
  }
  __device__ __forceinline__ int ld() const { return g.nxl + 2 * g.halo; }
  __device__ __forceinline__ size_t plane() const { return g.plane(); }
  __device__ __forceinline__ bool in_block(int ly, int lx) const {
    return y0 + ly < g.nyl && x0 + lx < g.nxl;
  }
  __device__ __forceinline__ bool counted(int ly, int lx) const {
    return g.counted(y0 + ly, x0 + lx);
  }
};

}  // namespace crd
