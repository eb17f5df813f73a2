// The z-streaming scheme of the port's fused step kernels on the 3-D box:
// its region, rings and offsets (StreamPlan, StreamSlots, the ring of
// variable 0, the chunk cones), shared by the embedded-ERK kernels K6
// (fused_box3d.cu, the whole box, StreamWrap) and K12 (fused_shard_box3d.cu,
// one shard's block inside the halo the exchange filled, StreamHalo) for an
// FSAL tableau of kStreamStages stages (bs32), defined here, and the RKC2
// chunk kernels K7 and K13 (box_rkc_stream.cuh) on the same grid policies.
// The launchers send the other ERK tableaus the gates take (zonneveld43,
// dopri54) to box3d.cuh's persistent kernels (ops/box_stream.py::
// uses_stream).
//
// An ordinary launch: each block owns one in-plane tile of kStreamTileX x
// kStreamTileY output points and one chunk of z_chunk planes
// (ops/box_stream.py::stream_plan), and marches up z through a software
// pipeline of at most kStreamDepth evaluations, as the TPU kernel's "3.5-D
// blocking" does (crdmodel_tpu/ops/pallas_box3d.py:10-35).
// For bs32, iteration p evaluates k_0 at plane p, k_1 at p - 1, k_2 at p - 2
// and k_3 at p - 3, in that order: k_s(q) reads its stage input Y_s at
// planes q - 1, q, q + 1, and Y_s(q) is complete once k_{s-1}(q) has been
// added, earlier in the same iteration. Only variable 0 of each Y_s is read
// at neighbours: it lives in a ring of three planes in shared memory, plane
// q in slot q % 3, on the tile and its kStreamDepth rings. What is
// pointwise stays with its point: a block's 512 threads are fixed to the
// points of the region for the whole launch (the tile first, row-major,
// then ring after ring, so a stage that needs fewer rings skips whole
// warps), and each point keeps the partial stage inputs (u and v) of the
// planes in flight in registers, lag by lag, and its error in registers
// (the profile mode) or in its own shared slot (the modes whose operators
// need the registers: tissue, field, tensor). When k_j(q) is computed it is
// added into every later Y_s(q) and the error, in stage order, so every
// value is formed in the plain loop's order (erk_tile.cuh, ops/fused_step.py
// ::erk_stages_from) and, with -fmad=false, bitwise the same. The tableau is
// FSAL (a[n-1] == b), so y_new is Y_{n-1} and needs no accumulator of its
// own. The update and the error's weights come at plane p - 3, the weights
// from y0 of that plane. The walls of z clamp the STAGE INPUT's plane: the
// plane above the top reads the top's slot, the one below the bottom the
// bottom's, as box3d.cuh's operator clamps y (boxes with nz < 4 too).
//
// Evaluation s of a pipeline of depth n runs on the tile and its n - 1 - s
// rings, at the planes its cone needs: a chunk [z0, z1) evaluates it on
// [z0 - (n-1-s), z1 + (n-1-s)), clamped to the box (stream_cone), so a chunk
// recomputes the n - 1 planes of the cone at its lower end and runs on past
// its upper end only where the box goes on. Four barriers an iteration:
// after the y plane enters ring 0 and after each stage's writes to the next
// ring. y is read about once (the rings and chunk cones aside), y_new
// written once, and no stage value goes to device memory.
//
// Each tile-and-chunk block writes one partial sum of its points' squared
// WRMS-scaled errors, in a fixed order that no occupancy changes: each
// thread adds its tile points' u and v squares plane by plane, slot by
// slot, then store_block_sum; ops/box_stream.py::stream_tile_sums replays
// it. The operator (stream_lap) computes box3d.cuh::box_lap's expressions
// in the same order, on u read from the rings and the constants read through
// each region point's in-plane offset (a shared table that carries the wrap
// or the halo clamp, computed once a launch); a tile point's profile
// coefficients, beta and live are read once a launch into registers, a
// ring point's at each evaluation. Where the error and the weights' y0
// live, and the width of the offsets, are chosen by mode: each the faster
// at the slab's shapes on the H100 (PERF.md, section 6).
//
// A structured forcing (Stim = rhs_common.cuh::BoxStimTable; NoStim
// compiles it out) joins each evaluation at the plane it runs at: stage s
// of iteration p at q = p - s reads amplitude column s and depth-table
// row q, the point's row and column from its slot's packed rc, which
// carries the wrap (StreamWrap) or the halo-padded buffer's index
// (StreamHalo), so the shard kernels read the halo-padded profiles alike
// (stream_forcing).

#pragma once

#include <cuda_runtime.h>

#include "box3d.cuh"
#include "erk_tile.cuh"

namespace crd {

constexpr int kStreamThreads = 512;   // ops/box_stream.py THREADS
// the region's rings, and the most evaluations a pass pipelines: bs32's
// four stages, an RKC2 chunk's at most four evaluations
constexpr int kStreamDepth = 4;       // DEPTH
constexpr int kStreamStages = kStreamDepth;   // STAGES: bs32
constexpr int kStreamTileX = 32;      // TILE_X

// Where a tile point keeps its error (fused_box_stream_kernel): in shared
// memory in the modes whose operators need more registers, in registers
// in the profile mode (ops/box_stream.py ERR_SHARED_MODES)
__host__ __device__ constexpr bool stream_err_shared(int mode) {
  return mode != kBoxProfile;
}

constexpr int kStreamTileY = 16;      // TILE_Y

// f32, the main paths': two blocks an SM (at most 64 registers); f64 one
template <typename T>
constexpr int kStreamMinBlocks = sizeof(T) == 4 ? 2 : 1;

// The block's region: the tile and kStreamDepth rings, kW x kR points;
// the slots of its points in onion order (the tile, then rings 1, 2, ...);
// the first evaluation of a pipeline kN deep runs on the tile and n - 1
// rings (kEval points), the outer ring is only read.
struct StreamPlan {
  static constexpr int kN = kStreamDepth;
  static constexpr int kTile = kStreamTileX * kStreamTileY;
  static constexpr int kW = kStreamTileX + 2 * kN;
  static constexpr int kR = kStreamTileY + 2 * kN;
  static constexpr int kRegion = kW * kR;
  static constexpr int kEval =
      (kStreamTileX + 2 * (kN - 1)) * (kStreamTileY + 2 * (kN - 1));
  static constexpr int kSlots =
      (kRegion + kStreamThreads - 1) / kStreamThreads;
  static constexpr int kEvalSlots =
      (kEval + kStreamThreads - 1) / kStreamThreads;
  static constexpr int kTileSlots = kTile / kStreamThreads;
  static_assert(kTile % kStreamThreads == 0, "a tile fills whole slots");

  // dynamic shared memory: a ring of three planes for each stage input's
  // variable 0, then `pointwise` values the kernel keeps in its threads'
  // own shared slots (bs32: the tile's errors of both variables on the kN
  // planes in flight where the mode keeps them there), then the region's
  // in-plane offsets (ops/box_stream.py::shared_bytes adds the static
  // warp sums)
  static constexpr size_t bytes(size_t itemsize, size_t pointwise) {
    return (static_cast<size_t>(3 * kN * kRegion) + pointwise) * itemsize
           + static_cast<size_t>(kRegion) * sizeof(int);
  }

  // region point q (onion order): local row ly, column lx and its ring
  // (0 on the tile); each ring's top row, bottom row, then its left and
  // right columns
  static __device__ void point(int q, int& ly, int& lx, int& ring) {
    if (q < kTile) {
      ring = 0;
      ly = kN + q / kStreamTileX;
      lx = kN + q % kStreamTileX;
      return;
    }
    q -= kTile;
    for (int r = 1; r <= kN; ++r) {
      const int w = kStreamTileX + 2 * r, h = kStreamTileY + 2 * r;
      const int n = 2 * w + 2 * (h - 2);
      if (q < n) {
        ring = r;
        if (q < w) {
          ly = kN - r;
          lx = kN - r + q;
        } else if (q < 2 * w) {
          ly = kN - r + h - 1;
          lx = kN - r + q - w;
        } else {
          const int e = q - 2 * w;
          ly = kN - r + 1 + e % (h - 2);
          lx = e < h - 2 ? kN - r : kN - r + w - 1;
        }
        return;
      }
      q -= n;
    }
    ring = kN + 1;
    ly = lx = 0;
  }
};

// The planes of a z chunk: as few equal chunks as bring a launch of
// in_plane tiles a plane to min_tiles blocks, at most one a plane
// (ops/box_stream.py::stream_plan).
__host__ __device__ inline int stream_z_chunk(int nz, int in_plane,
                                              int min_tiles) {
  const int want = (min_tiles + in_plane - 1) / in_plane;
  const int chunks = want < nz ? want : nz;
  return (nz + chunks - 1) / chunks;
}

// The grid policies: the row and column of the state's plane (and of the
// constants) of extent point (y, x), whether it lies in the extent grown
// by `rings` (in_extent: its y_new, or a chunk's hand-on values, are
// written), whether it enters the error sum (counted), and the rings
// beyond the extent that an RKC2 chunk with n_rest evaluations to come
// must cover (extent_rings).
//
// StreamWrap: the whole box of K6 and K7, x and y periodic (the wrap is a
// loop, once a launch a point; more than one step only on grids smaller
// than the region); a chunk covers the box.
struct StreamWrap {
  int ny;
  int nx;

  __device__ __forceinline__ int row(int y) const {
    while (y < 0) y += ny;
    while (y >= ny) y -= ny;
    return y;
  }
  __device__ __forceinline__ int col(int x) const {
    while (x < 0) x += nx;
    while (x >= nx) x -= nx;
    return x;
  }
  __device__ __forceinline__ bool in_extent(int y, int x, int) const {
    return y < ny && x < nx;
  }
  __device__ __forceinline__ bool counted(int y, int x) const {
    return in_extent(y, x, 0);
  }
  __host__ __device__ int extent_rings(int) const { return 0; }
  __host__ __device__ int extent_y() const { return ny; }
  __host__ __device__ int extent_x() const { return nx; }
};

// StreamHalo: one shard's block in its (nz, nyl + 2 halo, nxl + 2 halo)
// buffer (K12, K13); a region lies inside the buffer (halo >= the scheme's
// rings plus the extent's), the clamp at its edge only keeps the partial
// tiles' stray points inside it (they feed no point that is written). An
// RKC2 chunk covers the block grown by the evaluations still to come, so
// that its last chunk's tiles are the block's (ops/fused_shard_rkc.py::
// extent_rings). Mirror-pad cells step like the others and stay out of the
// sum.
struct StreamHalo {
  BoxShard s;
  int ny;    // the buffer's rows and columns
  int nx;

  __device__ __forceinline__ int row(int y) const {
    return min(max(y + s.halo, 0), ny - 1);
  }
  __device__ __forceinline__ int col(int x) const {
    return min(max(x + s.halo, 0), nx - 1);
  }
  __device__ __forceinline__ bool in_extent(int y, int x, int rings) const {
    return y < s.nyl + rings && x < s.nxl + rings;
  }
  __device__ __forceinline__ bool counted(int y, int x) const {
    return y < s.valid_rows && x < s.valid_cols;
  }
  __host__ __device__ int extent_rings(int n_rest) const { return n_rest; }
  __host__ __device__ int extent_y() const { return s.nyl; }
  __host__ __device__ int extent_x() const { return s.nxl; }
};

// A point's constants, read once a launch: the profile modes' four
// in-plane profiles at its row and column, beta and live of its row
template <typename T>
struct StreamPoint {
  T aE, aW, aN, aS;
  T beta, live;
};

template <int Mode, typename T>
__device__ __forceinline__ StreamPoint<T> stream_point(
    const BoxConstants<T>& c, T fz, int row, int col) {
  StreamPoint<T> p{};
  if (Mode == kBoxProfile || Mode == kBoxTissue) {
    p.aE = __ldg(c.c[0] + col);
    p.aW = __ldg(c.c[1] + col);
    p.aN = __ldg(c.c[2] + row);
    p.aS = __ldg(c.c[3] + row);
  }
  p.beta = beta_at(c.k, row);
  p.live = c.k.has_freeze ? live_at(c.k, fz, row) : T(1);
  return p;
}

// box3d.cuh::box_lap at plane k of the point at local index li of the
// region (row stride W), variable 0 read from the stage input's planes ud,
// um, uu (k - 1, k, k + 1, clamped: kD, kU) and the constants through the
// region's in-plane offsets goff: the same expressions in the same order.
template <int Mode, int W, typename T, typename Off>
__device__ __forceinline__ T stream_lap(const BoxConstants<T>& c,
                                        const StreamPoint<T>& p, const T* ud,
                                        const T* um, const T* uu,
                                        const int* goff, int li, int k,
                                        int kD, int kU, Off plane) {
  const T u = um[li];
  const T uE = um[li + 1], uW = um[li - 1];
  const T uN = um[li + W], uS = um[li - W];
  const T uU = uu[li], uD = ud[li];
  const Off gk = k * plane;
  T aE, aW, aN, aS, aU, aD;
  if (Mode == kBoxProfile || Mode == kBoxTissue) {
    aE = p.aE;
    aW = p.aW;
    aN = p.aN;
    aS = p.aS;
    aU = __ldg(c.c[4] + k);
    aD = __ldg(c.c[5] + k);
    if (Mode == kBoxTissue) {
      const T* tis = c.tissue;
      const T t = __ldg(tis + gk + goff[li]);
      aE = aE * (t * __ldg(tis + gk + goff[li + 1]));
      aW = aW * (t * __ldg(tis + gk + goff[li - 1]));
      aN = aN * (t * __ldg(tis + gk + goff[li + W]));
      aS = aS * (t * __ldg(tis + gk + goff[li - W]));
      aU = aU * (t * __ldg(tis + kU * plane + goff[li]));
      aD = aD * (t * __ldg(tis + kD * plane + goff[li]));
    }
  } else {
    aE = __ldg(c.c[0] + gk + goff[li]);
    aW = __ldg(c.c[0] + gk + goff[li - 1]);
    aN = __ldg(c.c[1] + gk + goff[li]);
    aS = __ldg(c.c[1] + gk + goff[li - W]);
    aU = __ldg(c.c[2] + gk + goff[li]);
    aD = k == 0 ? T(0) : __ldg(c.c[2] + (gk - plane) + goff[li]);
  }
  T lap = aE * (uE - u) + aW * (uW - u) + aN * (uN - u) + aS * (uS - u)
          + aU * (uU - u) + aD * (uD - u);
  if (Mode == kBoxTensor) {
    const T* dxy = c.c[3];
    const T* dxz = c.c[4];
    const T* dyz = c.c[5];
    const Off gE = gk + goff[li + 1], gW = gk + goff[li - 1];
    const Off gN = gk + goff[li + W], gS = gk + goff[li - W];
    const Off gU = kU * plane + goff[li];
    const Off gD = kD * plane + goff[li];
    // xy: fluxes Dxy (uN - uS) at i +- 1 and Dxy (uE - uW) at j +- 1
    const T uNE = um[li + W + 1], uSE = um[li - W + 1];
    const T uNW = um[li + W - 1], uSW = um[li - W - 1];
    const T t_xy = (__ldg(dxy + gE) * (uNE - uSE)
                    - __ldg(dxy + gW) * (uNW - uSW))
                   + (__ldg(dxy + gN) * (uNE - uNW)
                      - __ldg(dxy + gS) * (uSE - uSW));
    // xz: Dxz (uU - uD) at i +- 1 and Dxz (uE - uW) on the planes k +- 1
    const T uUE = uu[li + 1], uDE = ud[li + 1];
    const T uUW = uu[li - 1], uDW = ud[li - 1];
    const T t_xz = (__ldg(dxz + gE) * (uUE - uDE)
                    - __ldg(dxz + gW) * (uUW - uDW))
                   + (__ldg(dxz + gU) * (uUE - uUW)
                      - __ldg(dxz + gD) * (uDE - uDW));
    // yz: Dyz (uU - uD) at j +- 1 and Dyz (uN - uS) on the planes k +- 1
    const T uUN = uu[li + W], uDN = ud[li + W];
    const T uUS = uu[li - W], uDS = ud[li - W];
    const T t_yz = (__ldg(dyz + gN) * (uUN - uDN)
                    - __ldg(dyz + gS) * (uUS - uDS))
                   + (__ldg(dyz + gU) * (uUN - uUS)
                      - __ldg(dyz + gD) * (uDN - uDS));
    lap = ((lap + __ldg(c.invs) * t_xy) + __ldg(c.invs + 1) * t_xz)
          + __ldg(c.invs + 2) * t_yz;
  }
  return lap;
}

// box3d.cuh::box_rhs_at on the rings: ydot at the point, v its variable 1;
// kForced: plus a forcing's terms fu and fv (stream_forcing)
template <int Mode, int Kin, int W, bool kForced, typename T, typename Off>
__device__ __forceinline__ void stream_rhs(const BoxConstants<T>& c,
                                           const StreamPoint<T>& p,
                                           const T* ud, const T* um,
                                           const T* uu, const int* goff,
                                           int li, int k, int kD, int kU,
                                           Off plane, T v, T fu, T fv,
                                           T& du_out, T& dv_out) {
  const T lap = stream_lap<Mode, W>(c, p, ud, um, uu, goff, li, k, kD, kU,
                                    plane);
  T du, dv;
  kinetics<Kin>(um[li], v, p.beta, du, dv);
  add_operator<kForced>(lap, fu, fv, du, dv);
  if (c.k.has_freeze) {
    du = du * p.live;
    dv = dv * p.live;
  }
  if (c.tissue != nullptr) {
    const T tis = __ldg(c.tissue + k * plane + goff[li]);
    du = du * tis;
    dv = dv * tis;
  }
  du_out = du;
  dv_out = dv;
}

// A thread's points of its block's region, fixed for the launch: slot m
// holds region point threadIdx.x + kStreamThreads m (onion order). lr: its
// local index and, from bit 16, its ring (kN + 1: no point); go: its
// in-plane offset. The tile's slots (m < kTileSlots, ring 0) keep the
// point's constants and whether it lies in the extent (its y_new or hand-on
// values are written) and is counted; the rings' slots keep its row and
// column (rc, row from bit 16) and read the constants at each evaluation,
// which leaves their registers to the planes in flight.
template <typename T>
struct StreamSlots {
  int lr[StreamPlan::kSlots];
  int go[StreamPlan::kSlots];
  int rc[StreamPlan::kSlots];
  StreamPoint<T> pt[StreamPlan::kTileSlots];
  bool write[StreamPlan::kTileSlots];
  bool count[StreamPlan::kTileSlots];

  // slot m holds a point of the tile or of its first `rings` rings
  __device__ __forceinline__ bool within(int m, int rings) const {
    return lr[m] < (rings + 1) << 16;
  }
  __device__ __forceinline__ int local(int m) const { return lr[m] & 0xffff; }
  // the constants of slot m's point
  template <int Mode>
  __device__ __forceinline__ StreamPoint<T> point(const BoxConstants<T>& c,
                                                  T fz, int m) const {
    return m < StreamPlan::kTileSlots
               ? pt[m]
               : stream_point<Mode>(c, fz, rc[m] >> 16, rc[m] & 0xffff);
  }
};

// The slots of the region of the tile whose first point is extent point
// (ey0, ex0), the extent grown by `rings`; the region's in-plane offsets
// into goff.
template <int Mode, class Grid, typename T>
__device__ __forceinline__ void stream_slots(const BoxConstants<T>& c, T fz,
                                             const Grid& grid, int ey0,
                                             int ex0, int rings, int* goff,
                                             StreamSlots<T>& sl) {
  using P = StreamPlan;
  constexpr int NS = P::kN;
#pragma unroll
  for (int m = 0; m < P::kSlots; ++m) {
    const int q = static_cast<int>(threadIdx.x) + kStreamThreads * m;
    sl.lr[m] = (NS + 1) << 16;
    sl.go[m] = 0;
    sl.rc[m] = 0;
    if (q >= P::kRegion) continue;
    int ly, lx, r;
    P::point(q, ly, lx, r);
    const int ey = ey0 + ly - NS;
    const int ex = ex0 + lx - NS;
    const int row = grid.row(ey), col = grid.col(ex);
    const int li = ly * P::kW + lx;
    sl.lr[m] = m < P::kTileSlots ? li : li | r << 16;
    sl.go[m] = row * c.nx + col;
    sl.rc[m] = row << 16 | col;
    goff[li] = sl.go[m];
    if (m < P::kTileSlots) {
      sl.pt[m] = stream_point<Mode>(c, fz, row, col);
      sl.write[m] = grid.in_extent(ey, ex, rings);
      sl.count[m] = grid.counted(ey, ex);
    }
  }
}

// A structured forcing's terms (fu, fv) at amplitude column a and plane k
// of the point whose state row and column are packed in rc (StreamSlots::
// rc): the stimulus profiles share the state's plane layout, halo-padded
// on a shard (rhs_common.cuh::BoxStimTable); zero without a forcing.
template <typename T, class Stim>
__device__ __forceinline__ void stream_forcing(const Stim& stim, int a,
                                               int k, int rc, T& fu,
                                               T& fv) {
  fu = T(0);
  fv = T(0);
  if constexpr (Stim::kOn) stim.at(a, k, rc >> 16, rc & 0xffff, fu, fv);
}

// The cones of a pipeline of depth n on the z chunk [z0, z1) of a box of nz
// planes: evaluation i runs at the planes [lo[i], hi[i]).
template <int N>
__device__ __forceinline__ void stream_cone(int n, int z0, int z1, int nz,
                                            int (&lo)[N], int (&hi)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    lo[i] = max(z0 - (n - 1 - i), 0);
    hi[i] = min(z1 + (n - 1 - i), nz);
  }
}

// Ring 0, the first evaluation's input: on the slots of the tile and its
// first `rings` rings, planes p0 - 1 (clamped) and p0 of variable 0 of src
// (planes `plane` apart) into their slots, plane p0 + 1 into nu
// (stream_ring0_store puts it in place).
template <typename T, typename Off>
__device__ __forceinline__ void stream_ring0_begin(
    const T* src, T* ring0, const StreamSlots<T>& sl, int rings, int p0,
    int nz, Off plane, T (&nu)[StreamPlan::kSlots]) {
  constexpr int L = StreamPlan::kRegion;
  const Off kd = max(p0 - 1, 0) * plane;
  const Off k0 = p0 * plane;
  const Off kn = min(p0 + 1, nz - 1) * plane;
#pragma unroll
  for (int m = 0; m < StreamPlan::kSlots; ++m) {
    if (!sl.within(m, rings)) continue;
    const int li = sl.local(m);
    ring0[(max(p0 - 1, 0) % 3) * L + li] = src[kd + sl.go[m]];
    ring0[(p0 % 3) * L + li] = src[k0 + sl.go[m]];
    nu[m] = src[kn + sl.go[m]];
  }
}

// Iteration p: ring 0 takes plane p + 1 (nu); the plane above the top is
// the top's (reads clamp), never stored.
template <typename T>
__device__ __forceinline__ void stream_ring0_store(
    T* ring0, const StreamSlots<T>& sl, int rings, int p, int nz,
    const T (&nu)[StreamPlan::kSlots]) {
  if (p + 1 >= nz) return;
#pragma unroll
  for (int m = 0; m < StreamPlan::kSlots; ++m)
    if (sl.within(m, rings))
      ring0[((p + 1) % 3) * StreamPlan::kRegion + sl.local(m)] = nu[m];
}

// and reads plane p + 2 (clamped) of src into nu, for the next iteration
template <typename T, typename Off>
__device__ __forceinline__ void stream_ring0_load(
    const T* src, const StreamSlots<T>& sl, int rings, int p, int nz,
    Off plane, T (&nu)[StreamPlan::kSlots]) {
  const Off kn = min(p + 2, nz - 1) * plane;
#pragma unroll
  for (int m = 0; m < StreamPlan::kSlots; ++m)
    if (sl.within(m, rings)) nu[m] = src[kn + sl.go[m]];
}

// One bs32 step on the tile (blockIdx.x, blockIdx.y) of kStreamTileX x
// kStreamTileY extent points and the z chunk blockIdx.z of z_chunk planes;
// with a forcing (Stim a BoxStimTable), stage s at plane q adds its terms
// at amplitude column s and plane q.
template <int Mode, int Kin, class Grid, typename T, class Stim>
__global__ void __launch_bounds__(kStreamThreads, (kStreamMinBlocks<T>))
    fused_box_stream_kernel(const T* __restrict__ y, T* __restrict__ y_new,
                            T* __restrict__ ss, const T* __restrict__ h_ptr,
                            const T* __restrict__ fz_ptr, BoxConstants<T> c,
                            Grid grid, StageTable tab, int z_chunk, T rtol,
                            T atol, Stim stim) {
  using P = StreamPlan;
  constexpr int NS = kStreamStages;
  constexpr int S = P::kSlots;
  constexpr int SE = P::kEvalSlots;
  constexpr int ST = P::kTileSlots;
  constexpr int W = P::kW;
  constexpr int L = P::kRegion;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kStreamThreads / 32];
  T* const rings = reinterpret_cast<T*>(smem_raw);    // [NS][3][L]
  // the error of tile point i of plane q, variable v: errs[((q % NS) * 2
  // + v) * kTile + i], each thread its own points' (no barrier)
  T* const errs = rings + 3 * NS * L;
  int* const goff = reinterpret_cast<int*>(
      errs + (stream_err_shared(Mode) ? 2 * NS * P::kTile : 0));
  // offsets into the state: 64-bit in the profile mode, 32-bit in the
  // others (the faster choice in each, measured at the slab's shapes; the
  // launcher checks that 32 bits hold them)
  using Off = std::conditional_t<Mode == kBoxProfile, size_t, int>;
  const int nz = c.nz;
  const Off plane = static_cast<Off>(c.ny) * c.nx;
  const Off var1 = plane * nz;          // variable 1's offset
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  const int z0 = blockIdx.z * z_chunk;
  const int z1 = min(z0 + z_chunk, nz);

  StreamSlots<T> sl;
  stream_slots<Mode>(c, fz, grid,
                     static_cast<int>(blockIdx.y) * kStreamTileY,
                     static_cast<int>(blockIdx.x) * kStreamTileX, 0, goff,
                     sl);

  // stage s runs at planes [lo[s], hi[s]); iteration p takes k_s(p - s)
  int lo[NS], hi[NS];
  stream_cone(NS, z0, z1, nz, lo, hi);
  const int p_first = lo[0];
  const int p_end = z1 + NS - 1;

  // ring 0 holds y's variable 0: planes p_first - 1 (clamped) and
  // p_first now, plane p + 1 from iteration p on, loaded one iteration
  // ahead (nu)
  T nu[S];
  stream_ring0_begin(y, rings, sl, NS, p_first, nz, plane, nu);

  // the planes in flight, lag by lag (lag l: plane p - l, after k_0 ..
  // k_{l-1}): su[l][t], sv[l][t] Y_t's u and v (u of t > l; Y_l's u is in
  // ring l). A tile point's error: in the profile mode eu[l], ev[l] in
  // registers; in the others, whose operators need more registers, in
  // shared memory (errs). Its weights' y0: w0u, w0v, loaded an iteration
  // ahead, but for the tensor mode, which reads it at the update (the
  // fastest choices at the slab's shapes, PERF.md).
  constexpr bool kErrShared = stream_err_shared(Mode);
  constexpr bool kW0Ahead = Mode != kBoxTensor;
  T su[NS][NS][S], sv[NS][NS][S], eu[NS][ST], ev[NS][ST];
  T w0u[ST], w0v[ST];
  T acc = T(0);
  for (int p = p_first; p < p_end; ++p) {
    stream_ring0_store(rings, sl, NS, p, nz, nu);
    // variable 1 of plane p; plane p + 2's variable 0 for the next
    // iteration; y0 of plane p - (NS - 1)
    T v0[SE];
    stream_ring0_load(y, sl, NS, p, nz, plane, nu);
    {
      const Off k0 = min(p, nz - 1) * plane;
      const Off kw = max(p - (NS - 1), 0) * plane;
#pragma unroll
      for (int m = 0; m < SE; ++m) {
        if (!sl.within(m, NS)) continue;
        v0[m] = y[var1 + k0 + sl.go[m]];
        if (kW0Ahead && m < ST) {
          w0u[m] = y[kw + sl.go[m]];
          w0v[m] = y[var1 + kw + sl.go[m]];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s > 0) __syncthreads();    // ring s holds Y_s(p - s + 1)
      const int q = p - s;
      if (q < lo[s] || q >= hi[s]) continue;    // the same for every thread
      const int kU = min(q + 1, nz - 1), kD = max(q - 1, 0);
      const T* const in = rings + s * 3 * L;
      const T* const um = in + (q % 3) * L;
      const T* const uu = in + (kU % 3) * L;
      const T* const ud = in + (kD % 3) * L;
#pragma unroll
      for (int m = 0; m < SE; ++m) {
        // stage s on the tile and NS - 1 - s rings
        if (m >= ST && !sl.within(m, NS - 1 - s)) continue;
        const int li = sl.local(m);
        if (s == 0) {        // the plane's stage inputs start from y0
#pragma unroll
          for (int t = 1; t < NS; ++t) su[0][t][m] = um[li];
#pragma unroll
          for (int t = 0; t < NS; ++t) sv[0][t][m] = v0[m];
        }
        T du, dv, fu, fv;
        stream_forcing(stim, s, q, sl.rc[m], fu, fv);
        stream_rhs<Mode, Kin, W, Stim::kOn>(
            c, sl.template point<Mode>(c, fz, m), ud, um, uu, goff, li, q,
            kD, kU, plane, sv[s][s][m], fu, fv, du, dv);
        // k_s into the inputs of the stages after it and the error, each
        // in stage order
#pragma unroll
        for (int t = s + 1; t < NS; ++t) {
          if (tab.a[t][s] != 0.0) {
            const T ha = h * static_cast<T>(tab.a[t][s]);
            su[s][t][m] = su[s][t][m] + ha * du;
            sv[s][t][m] = sv[s][t][m] + ha * dv;
          }
        }
        if (s < NS - 1)      // Y_{s+1}(q) is complete
          rings[((s + 1) * 3 + q % 3) * L + li] = su[s][s + 1][m];
        if (m >= ST) continue;
        // the tile point's error: 0 with k_0, then k_s added; in shared
        // memory its plane's slot, q % NS
        T* const e = errs + (q % NS) * 2 * P::kTile + threadIdx.x
                     + kStreamThreads * m;
        if (s == 0) {
          if constexpr (kErrShared) {
            e[0] = T(0);
            e[P::kTile] = T(0);
          } else {
            eu[0][m] = T(0);
            ev[0][m] = T(0);
          }
        }
        if (tab.d[s] != 0.0) {
          const T hd = h * static_cast<T>(tab.d[s]);
          if constexpr (kErrShared) {
            e[0] = e[0] + hd * du;
            e[P::kTile] = e[P::kTile] + hd * dv;
          } else {
            eu[s][m] = eu[s][m] + hd * du;
            ev[s][m] = ev[s][m] + hd * dv;
          }
        }
        if (s == NS - 1) {
          // y_new is the last stage's input (FSAL); the error is complete
          const Off g = q * plane + sl.go[m];
          if (sl.write[m]) {
            y_new[g] = su[s][s][m];
            y_new[var1 + g] = sv[s][s][m];
          }
          if (sl.count[m]) {      // the weights from y0
            const T fu = kErrShared ? e[0] : eu[s][m];
            const T fv = kErrShared ? e[P::kTile] : ev[s][m];
            const T yu = kW0Ahead ? w0u[m] : y[g];
            const T yv = kW0Ahead ? w0v[m] : y[var1 + g];
            const T wu = fu * (T(1) / (rtol * fabs(yu) + atol));
            const T wv = fv * (T(1) / (rtol * fabs(yv) + atol));
            acc = acc + wu * wu;
            acc = acc + wv * wv;
          }
        }
      }
    }
    // the planes in flight move up one lag
#pragma unroll
    for (int l = NS - 1; l > 0; --l) {
#pragma unroll
      for (int m = 0; m < S; ++m) {
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          su[l][t][m] = su[l - 1][t][m];
          sv[l][t][m] = sv[l - 1][t][m];
        }
        if (!kErrShared && m < ST) {
          eu[l][m] = eu[l - 1][m];
          ev[l][m] = ev[l - 1][m];
        }
      }
    }
  }
  store_block_sum<T, kStreamThreads>(
      acc, warp_sums, ss + blockIdx.z * gridDim.x * gridDim.y);
}

// The scheme takes the tableau: kStreamStages stages, FSAL
// (ops/box_stream.py::uses_stream).
inline bool stream_take(const StageTable& tab) {
  return tab.n == kStreamStages && stage_table_is_fsal(tab);
}

// Shared bytes of the bs32 kernel in `mode` (ops/box_stream.py::
// shared_bytes, less the static warp sums).
constexpr size_t stream_bytes(size_t itemsize, int mode) {
  return StreamPlan::bytes(
      itemsize, stream_err_shared(mode)
                    ? 2 * StreamPlan::kN * StreamPlan::kTile
                    : 0);
}

// Launch one step over the tiles of grid's extent on `stream`: ntx x nty
// tiles of kStreamTileX x kStreamTileY (tile_y, the plan's, must be it),
// ceil(nz / z_chunk) chunks, one partial sum each (at most `capacity`,
// their count to *n_blocks), with the forcing `stim` (NoStim: none);
// returns the CUDA error code, checked right after the launch.
template <typename T, class Grid, class Stim>
int launch_box_stream(const BoxConstants<T>& c, Grid grid, int mode,
                      int kinetics, const void* y, void* y_new, void* ss,
                      int capacity, int* n_blocks, const void* h,
                      const void* fz, const StageTable& tab, int tile_y,
                      int z_chunk, double rtol, double atol, void* stream,
                      const Stim& stim) {
  // offsets into the state in an int, rows and columns in 16 bits each
  if (tile_y != kStreamTileY || z_chunk < 1
      || 2LL * c.nz * c.ny * c.nx >= (1LL << 31) || c.ny > 0xffff
      || c.nx > 0xffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntx = (grid.extent_x() + kStreamTileX - 1) / kStreamTileX;
  const int nty = (grid.extent_y() + kStreamTileY - 1) / kStreamTileY;
  const int chunks = (c.nz + z_chunk - 1) / z_chunk;
  const long long tiles = static_cast<long long>(ntx) * nty * chunks;
  if (tiles > capacity) return static_cast<int>(cudaErrorInvalidValue);
  *n_blocks = static_cast<int>(tiles);
  return dispatch_box(mode, kinetics, [&](auto m, auto k) {
    auto kernel =
        &fused_box_stream_kernel<decltype(m)::value, decltype(k)::value, Grid,
                                 T, Stim>;
    const size_t smem = stream_bytes(sizeof(T), decltype(m)::value);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(ntx, nty, chunks), kStreamThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
        static_cast<const T*>(h), static_cast<const T*>(fz), c, grid, tab,
        z_chunk, static_cast<T>(rtol), static_cast<T>(atol), stim);
    return static_cast<int>(cudaGetLastError());
  });
}

// out[0] the resident blocks an SM, out[1] the registers a thread, out[2]
// the shared bytes a block (static and dynamic) of `kernel` with `smem`
// bytes of dynamic shared memory; returns the CUDA error code.
template <typename Kernel>
int stream_info(Kernel kernel, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                        kStreamThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

// stream_info of the unforced bs32 kernel of (mode, kinetics) on the grid
// policy Grid.
template <typename T, class Grid>
int stream_kernel_info(int mode, int kinetics, int* out) {
  return dispatch_box(mode, kinetics, [&](auto m, auto k) {
    return stream_info(
        &fused_box_stream_kernel<decltype(m)::value, decltype(k)::value, Grid,
                                 T, NoStim>,
        stream_bytes(sizeof(T), decltype(m)::value), out);
  });
}

}  // namespace crd
