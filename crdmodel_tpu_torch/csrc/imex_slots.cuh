// The register-resident tile scheme of the port's fused IMEX ARK3(2)4L[2]SA
// step: K3 (fused_imex.cu, the periodic grid, WrapGrid) and K10
// (fused_shard_imex.cu, one shard's block in the halo the exchange filled,
// HaloGrid), written over the grid policy (SlotOrigin, tile_slots.cuh).
//
// One launch performs a whole additive Runge-Kutta step
// (integrate/imex.py::make_imex_step_err) on 32 x TileY tiles with 4 rings,
// one ring per explicit evaluation: the 4 explicit stencil evaluations
// kE_i = f_ex(Y_i); the 3 implicit stages, each solving
// Y = rhs_known + (h gamma) f_im(Y) at every point by 3 full Newton
// iterations (closed-form 2x2 Jacobian, residual, Cramer solve with IEEE
// divisions); kI_i = (Y_i - rhs_known_i)/(h gamma); y_new = y0 +
// sum (h B_j)(kE_j + kI_j); err = sum (h D_j)(kE_j + kI_j); and one partial
// sum a tile of sum (err w)^2 + (1/NEWTON_TOL)^2 sum_stages (dy w)^2, with
// w = 1/(rtol |y0| + atol) and dy each stage's last Newton update, over the
// points the grid counts (summed by the caller; no float atomics, so two
// launches on the same input give bitwise-equal results). A zero
// determinant gives NaN, which reaches the sum (a rejected step): nothing
// is masked. Stage s's Newton runs on every point at depth >= s (the tile
// grown by 4 - s rings), because stage s + 1's stencil reads Y_s there.
//
// A block of kImexSlotThreads threads owns a tile; each thread is fixed
// to kTileSlots points of the tile (q = t + 512 m: two on a 32x32 tile,
// one on a 32x16 one) and to at most one point of the 3 rings around it
// that the Newton also runs on (420 or 324 points: the stage values there
// feed the stencils of the later stages; stage s runs on the rings at
// depth >= s, the rings ordered by depth so that whole warps skip), for
// the whole launch; the outer ring, which only the first stencil reads,
// is loaded by threads of its own. A point's pointwise state stays in its
// thread's registers: the rhs_known of the stages to come, each
// accumulated as its terms become known (j order, AE before AI within a
// j, as imex_stages_reference), the predictor's kI of the stage before,
// and on the tile the weights and the update's and the error's sums (B
// and D in j order). Only variable 0 diffuses, so only what its stencil
// reads at neighbours goes through shared memory: y0's u and the stage
// value of variable 0, three planes of the region in all, one block
// barrier a stage; kE of variable 1 is 0 and never formed. The operator's
// coefficients (the three profiles of the region's columns, beta and live
// of its rows) and the tableau's products h AE, h AI, h B, h D are staged
// in shared memory once a block, the tableau from T values prepared on the
// host; the zero pattern of ARK3(2)4L[2]SA (every AE and AI entry below
// the diagonal, every B and D non-zero) is the kernel's at compile time,
// and the launcher refuses a tableau of another pattern. A tile whose
// region lies inside the grid (or the shard's buffer) takes code without
// the wrap (or the clamp). Each point's arithmetic follows the plain
// version (ops/fused_imex.py::imex_stages_reference) operation for
// operation, and the library is built with -fmad=false.
//
// The partial sums keep the order of the 256-thread one-pass block of K3's
// first port, so that the Newton's share of the convergence test, and with
// it a run's steps, do not move: the squared scaled Newton updates of the
// three stages and the squared scaled errors of the tile's points are
// staged in shared memory, and threads 0..255 replay what that block's 256
// threads added: thread t its Newton points of stage s in the strided
// order over the (40 - 2s) x (TileY + 8 - 2s) region, restricted to the
// tile's counted cells, then its tile points (stride 256, u then v), then
// acc + 100 dacc; the block's reduction adds the other warps' +0.0
// (exact). ops/fused_imex.py::imex_tile_sums is its plain model.
//
// A structured forcing (K3: Stim = StimTable, rhs_common.cuh;
// pallas_imex.py:190-217, 232-240, 312) joins the explicit evaluations
// only, at the ARK c nodes: kE_i = (lap + f_u, f_v) times live, f the
// stimuli's (amps[j][i] * rows[j][r]) * cols[j][c] at the point's row
// and column indices (r, c) (the wrapped ones on the rings). The Newton
// stages stay pointwise and autonomous. kE of variable 1, f_v times live,
// then enters rhs_known, the update and the error as kE of variable 0
// does. Stim = NoStim compiles it out: the unforced kernels are the ones
// before it.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "rhs_common.cuh"
#include "tile_slots.cuh"

namespace crd {

constexpr int kImexStages = 4;
constexpr int kImexHalo = 4;             // one ring per explicit evaluation
constexpr int kImexNewtonIters = 3;      // integrate/imex.py NEWTON_ITERS
constexpr double kImexNewtonPenalty = 100.0;   // (1 / NEWTON_TOL)^2
constexpr int kImexSlotThreads = 512;    // ops/fused_imex.py THREADS
constexpr int kImexSumThreads = 256;     // the partial sums' order
constexpr int kImexTile = 32;            // the tiles' width (x, contiguous)

struct ImexTable {
  double ae[kImexStages][kImexStages];
  double ai[kImexStages][kImexStages];
  double b[kImexStages];
  double d[kImexStages];                 // b - bhat
  double gamma;
};

// AE and AI row-major (4 x 4), B and D of 4 stages, and gamma
inline ImexTable make_imex_table(const double* ae, const double* ai,
                                 const double* b, const double* d,
                                 double gamma) {
  ImexTable tab = {};
  for (int s = 0; s < kImexStages; ++s) {
    for (int j = 0; j < kImexStages; ++j) {
      tab.ae[s][j] = ae[s * kImexStages + j];
      tab.ai[s][j] = ai[s * kImexStages + j];
    }
    tab.b[s] = b[s];
    tab.d[s] = d[s];
  }
  tab.gamma = gamma;
  return tab;
}

// The block's plan for 32 x TileY tiles (ops/fused_imex.py::slots_plan):
// the region, W x R points, the tile and its 4 rings; the tile's slots a
// thread; the Newton's 3 rings around the tile (depth 1..3, one point a
// thread) and the outer ring (depth 0)
template <int TileY>
struct ImexPlan {
  static constexpr int kW = kImexTile + 2 * kImexHalo;    // 40
  static constexpr int kR = TileY + 2 * kImexHalo;        // 40 or 24
  static constexpr int kRegion = kW * kR;
  static constexpr int kTilePoints = kImexTile * TileY;
  static constexpr int kTileSlots = kTilePoints / kImexSlotThreads;
  static constexpr int kRing = (kW - 2) * (kR - 2) - kTilePoints;
  static constexpr int kOuter = 2 * (kW + kR) - 4;
  // the stages' staged terms: the Newton updates of 3 stages and the
  // errors, two variables each, on the tile
  static constexpr int kStaged = 2 * kImexStages * kTilePoints;
  // dynamic shared memory (in T): y0's u and two stage planes of the
  // region, the staged terms
  static constexpr int kElements = 3 * kRegion + kStaged;
  static_assert(kTileSlots * kImexSlotThreads == kTilePoints,
                "whole tile slots");
  static_assert(kRing <= kImexSlotThreads, "one ring slot");
  static_assert(kOuter <= kImexSlotThreads, "one outer point a thread");
  static_assert(kR <= 64 && kW <= 64, "the coefficients' staging threads");

  // the points of the region's rectangular ring at depth d
  static __host__ __device__ constexpr int ring_size(int d) {
    return 2 * (kW + kR) - 8 * d - 4;
  }
  // the local index of point i of the ring at depth d: its first row, its
  // last row, then its side columns two a row
  static __device__ __forceinline__ int ring_point(int d, int i) {
    const int L = kW - 2 * d, H = kR - 2 * d;
    if (i < L) return d * kW + d + i;
    if (i < 2 * L) return (d + H - 1) * kW + d + i - L;
    const int j = i - 2 * L;
    return (d + 1 + j / 2) * kW + ((j & 1) ? d + L - 1 : d);
  }
};

// f32: two blocks an SM (at most 64 registers); f64: one
template <typename T>
constexpr int kImexMinBlocks = sizeof(T) == 4 ? 2 : 1;

// The tableau in T, prepared on the host (rows and columns as ImexTable's)
template <typename T>
struct ImexCoeffs {
  T ae[kImexStages][kImexStages];
  T ai[kImexStages][kImexStages];
  T b[kImexStages];
  T d[kImexStages];
  T gamma;
};

// The pattern the kernel takes at compile time: every AE and AI entry
// below the diagonal, every B and D non-zero (ARK3(2)4L[2]SA's); the T
// values of `tab` into *out.
template <typename T>
inline bool imex_slots_take(const ImexTable& tab, ImexCoeffs<T>* out) {
  *out = {};
  for (int s = 0; s < kImexStages; ++s) {
    for (int j = 0; j < s; ++j) {
      if (tab.ae[s][j] == 0.0 || tab.ai[s][j] == 0.0) return false;
      out->ae[s][j] = static_cast<T>(tab.ae[s][j]);
      out->ai[s][j] = static_cast<T>(tab.ai[s][j]);
    }
    if (tab.b[s] == 0.0 || tab.d[s] == 0.0) return false;
    out->b[s] = static_cast<T>(tab.b[s]);
    out->d[s] = static_cast<T>(tab.d[s]);
  }
  out->gamma = static_cast<T>(tab.gamma);
  return true;
}

// The Newton of one implicit stage at one point: Y = rhs_known +
// (h gamma) f_im(Y) from the predictor (Yu, Yv), the last update in
// (du, dv); imex_stages_reference's arithmetic, operation for operation.
template <int Kin, typename T>
__device__ __forceinline__ void imex_newton(T hg, T ru, T rv, T b, T live,
                                            bool freeze, T& Yu, T& Yv, T& du,
                                            T& dv) {
  du = T(0);
  dv = T(0);
#pragma unroll 1
  for (int it = 0; it < kImexNewtonIters; ++it) {
    T j00, j01, j10, j11, fu, fv;
    jacobian<Kin>(Yu, Yv, b, j00, j01, j10, j11);
    kinetics<Kin>(Yu, Yv, b, fu, fv);
    if (freeze) {
      j00 = j00 * live;
      j01 = j01 * live;
      j10 = j10 * live;
      j11 = j11 * live;
      fu = fu * live;
      fv = fv * live;
    }
    const T m00 = T(1) - hg * j00, m01 = T(0) - hg * j01;
    const T m10 = T(0) - hg * j10, m11 = T(1) - hg * j11;
    const T r0 = -((Yu - hg * fu) - ru);
    const T r1 = -((Yv - hg * fv) - rv);
    const T det = m00 * m11 - m01 * m10;
    du = (m11 * r0 - m01 * r1) / det;
    dv = (m00 * r1 - m10 * r0) / det;
    Yu = Yu + du;
    Yv = Yv + dv;
  }
}

// One step over the extent the grid's tiles cover (the grid's, or the
// shard's block), a 32 x TileY tile a block.
template <int Kin, class Grid, typename T, int TileY, class Stim>
__global__ void __launch_bounds__(kImexSlotThreads, (kImexMinBlocks<T>))
    fused_imex_slots_kernel(const T* __restrict__ y, T* __restrict__ y_new,
                            T* __restrict__ ss, const T* __restrict__ h_ptr,
                            const T* __restrict__ fz_ptr, RhsConstants<T> k,
                            Grid grid, ImexCoeffs<T> tab, T rtol, T atol,
                            Stim stim) {
  using Plan = ImexPlan<TileY>;
  constexpr int NS = kImexStages;
  constexpr int W = Plan::kW;
  constexpr int R = Plan::kR;
  constexpr int kTile = kImexTile;
  constexpr int kTP = Plan::kTilePoints;
  constexpr int kTS = Plan::kTileSlots;
  constexpr int kT = kImexSlotThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kT / 32];
  // h times the tableau's entries, formed once a block
  __shared__ T hae[NS][NS], hai[NS][NS], hb[NS], hd[NS];
  // the profile operator's coefficients of the region's columns (c0, c1,
  // c2) and rows (beta, live), read once a block
  __shared__ T colc[3][W], rowc[2][R];
  T* const u0s = reinterpret_cast<T*>(smem_raw);   // y0's u on the region
  T* const ys[2] = {u0s + Plan::kRegion,           // the stage value's u:
                    u0s + 2 * Plan::kRegion};      // stages 1, 3 / 2
  // the staged terms: dy2[(s - 1) * 2 + var][q] and e2[var][q] on the tile
  T* const dy2 = u0s + 3 * Plan::kRegion;
  T* const e2 = dy2 + 2 * (NS - 1) * kTP;
  const SlotOrigin<Grid> o(grid, blockIdx.y * TileY, blockIdx.x * kTile,
                           kImexHalo, W, R);
  const size_t plane = o.plane();
  const T h = *h_ptr;
  const T fz = k.has_freeze ? *fz_ptr : T(0);
  const T hg = h * tab.gamma;
  const bool freeze = k.has_freeze != 0;
  if (threadIdx.x < NS) {
    const int s = threadIdx.x;
    for (int j = 0; j < s; ++j) {
      hae[s][j] = h * tab.ae[s][j];
      hai[s][j] = h * tab.ai[s][j];
    }
    hb[s] = h * tab.b[s];
    hd[s] = h * tab.d[s];
  }
  // thread t's Newton ring point: the rings at depth 1, 2, 3 in turn, so
  // that the warps whose points a stage no longer needs skip it whole
  const int t = threadIdx.x;
  constexpr int kD1 = Plan::ring_size(1);
  constexpr int kD2 = kD1 + Plan::ring_size(2);
  const int ring_depth = t < kD1 ? 1 : t < kD2 ? 2 : t < Plan::kRing ? 3 : 0;
  const int ring_p = Plan::ring_point(
      ring_depth > 0 ? ring_depth : 1,
      t < kD1 ? t : t < kD2 ? t - kD1 : t < Plan::kRing ? t - kD2 : 0);

  // the step on the tile; kIn: the region lies inside the grid
  const auto step = [&](auto inner) {
    constexpr bool kIn = decltype(inner)::value;
    const auto row = [&](int p) { return o.template row<kIn>(p / W); };
    const auto col = [&](int p) { return o.template col<kIn>(p % W); };
    const auto at = [&](int p) {
      return static_cast<size_t>(row(p)) * o.ld() + col(p);
    };
    // the slots: 0 .. kTS - 1 on the tile, kTS on the Newton's rings
    constexpr int S = kTS + 1;
    int pt[S];
#pragma unroll
    for (int m = 0; m < kTS; ++m)
      pt[m] = (kImexHalo + (t >> 5) + m * (kT / kTile)) * W + kImexHalo
              + (t & 31);
    pt[kTS] = ring_p;
    // slot m is needed by what runs on the points `depth` or more rings in
    const auto live_slot = [&](int m, int depth) {
      return m < kTS || ring_depth >= depth;
    };
    // the coefficients, the columns by threads 0..W-1 and the rows by
    // threads 64..64+R-1
    if (t < W) {
      const int c = k.torus ? o.template col<kIn>(t) : 0;
      colc[0][t] = k.c0[c];
      colc[1][t] = k.c1[c];
      colc[2][t] = k.c2[c];
    } else if (t >= 64 && t < 64 + R) {
      const int r = o.template row<kIn>(t - 64);
      rowc[0][t - 64] = beta_at(k, r);
      rowc[1][t - 64] = freeze ? live_at(k, fz, r) : T(1);
    }
    // the operator at local point p on the plane su, from the staged
    // coefficients
    const auto lap_at = [&](const T* su, int p) {
      const int lx = p % W;
      return profile_lap_of(colc[0][lx], colc[1][lx], colc[2][lx],
                            k.torus != 0, su, p, W);
    };
    // explicit evaluation i at local point p: kE_i's variable 0 into lap
    // and, with a forcing, variable 1 into xv, both times live
    const auto explicit_at = [&](int i, const T* su, int p, T& lap, T& xv) {
      lap = lap_at(su, p);
      xv = T(0);
      if constexpr (Stim::kOn) {
        T gu;
        stim.at(i, row(p), col(p), gu, xv);
        lap = lap + gu;
      }
      if (freeze) {
        const T live = rowc[1][p / W];
        lap = lap * live;
        if constexpr (Stim::kOn) xv = xv * live;
      }
    };
    // the step's start: u on the region, the outer ring by the first
    // kOuter threads, the slots' points by their own threads
    if (t < Plan::kOuter) {
      const int p = Plan::ring_point(0, t);
      u0s[p] = y[at(p)];
    }
    T v0[S];
#pragma unroll
    for (int m = 0; m < S; ++m) {
      v0[m] = T(0);
      if (!live_slot(m, 1)) continue;
      const size_t g = at(pt[m]);
      u0s[pt[m]] = y[g];
      v0[m] = y[plane + g];
    }
    __syncthreads();

    // rhs_known of stages 1..3, the predictor's kI, and on the tile the
    // weights and the update's and the error's sums
    T rku[S][NS - 1], rkv[S][NS - 1], kiu[S], kiv[S];
    T wu[kTS], wv[kTS], nu[kTS], nv[kTS], eu[kTS], ev[kTS];
    // stage 0: kE_0 = f_ex(y0), kI_0 = f_im(y0)
#pragma unroll
    for (int m = 0; m < S; ++m) {
      if (!live_slot(m, 1)) continue;
      const int p = pt[m];
      const int ly = p / W;
      const T u0 = u0s[p];
      T lap, xv;
      explicit_at(0, u0s, p, lap, xv);
      T fu, fv;
      kinetics<Kin>(u0, v0[m], rowc[0][ly], fu, fv);
      if (freeze) {
        const T live = rowc[1][ly];
        fu = fu * live;
        fv = fv * live;
      }
#pragma unroll
      for (int s = 1; s < NS; ++s) {
        rku[m][s - 1] = u0 + hae[s][0] * lap;
        rku[m][s - 1] = rku[m][s - 1] + hai[s][0] * fu;
        if constexpr (Stim::kOn) {
          rkv[m][s - 1] = v0[m] + hae[s][0] * xv;
          rkv[m][s - 1] = rkv[m][s - 1] + hai[s][0] * fv;
        } else {
          rkv[m][s - 1] = v0[m] + hai[s][0] * fv;
        }
      }
      kiu[m] = fu;
      kiv[m] = fv;
      if (m < kTS) {
        wu[m] = T(1) / (rtol * fabs(u0) + atol);
        wv[m] = T(1) / (rtol * fabs(v0[m]) + atol);
        const T ksu = lap + fu;
        const T ksv = Stim::kOn ? xv + fv : fv;
        nu[m] = u0 + hb[0] * ksu;
        nv[m] = v0[m] + hb[0] * ksv;
        eu[m] = T(0) + hd[0] * ksu;
        ev[m] = T(0) + hd[0] * ksv;
      }
    }

    // implicit stages s = 1..3, each followed by its explicit evaluation
    // (kE_3 on the tile after the loop)
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      T* const yp = ys[(s - 1) & 1];
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (!live_slot(m, s)) continue;
        const int p = pt[m];
        const int ly = p / W;
        const T ru = rku[m][s - 1], rv = rkv[m][s - 1];
        T Yu = ru + hg * kiu[m];
        T Yv = rv + hg * kiv[m];
        T du, dv;
        imex_newton<Kin>(hg, ru, rv, rowc[0][ly], rowc[1][ly], freeze, Yu,
                         Yv, du, dv);
        yp[p] = Yu;
        kiu[m] = (Yu - ru) / hg;
        kiv[m] = (Yv - rv) / hg;
        if (m < kTS) {
          const int q = t + kT * m;
          const int lx = p % W;
          const bool on = o.in_block(ly, lx) && o.counted(ly, lx);
          const T su = du * wu[m], sv = dv * wv[m];
          dy2[(2 * s - 2) * kTP + q] = on ? su * su : T(0);
          dy2[(2 * s - 1) * kTP + q] = on ? sv * sv : T(0);
        }
      }
      __syncthreads();
      if (s == NS - 1) break;
      // kE_s on the slots, into the later stages' rhs_known and the sums
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (!live_slot(m, s + 1)) continue;
        const int p = pt[m];
        T lap, xv;
        explicit_at(s, yp, p, lap, xv);
#pragma unroll
        for (int r = s + 1; r < NS; ++r) {
          rku[m][r - 1] = rku[m][r - 1] + hae[r][s] * lap;
          rku[m][r - 1] = rku[m][r - 1] + hai[r][s] * kiu[m];
          if constexpr (Stim::kOn)
            rkv[m][r - 1] = rkv[m][r - 1] + hae[r][s] * xv;
          rkv[m][r - 1] = rkv[m][r - 1] + hai[r][s] * kiv[m];
        }
        if (m < kTS) {
          const T ksu = lap + kiu[m];
          const T ksv = Stim::kOn ? xv + kiv[m] : kiv[m];
          nu[m] = nu[m] + hb[s] * ksu;
          nv[m] = nv[m] + hb[s] * ksv;
          eu[m] = eu[m] + hd[s] * ksu;
          ev[m] = ev[m] + hd[s] * ksv;
        }
      }
    }

    // kE_3, y_new and the error on the tile
    const T* const y3 = ys[(NS - 2) & 1];
#pragma unroll
    for (int m = 0; m < kTS; ++m) {
      const int p = pt[m];
      const int q = t + kT * m;
      const int ly = p / W, lx = p % W;
      if (!o.in_block(ly, lx)) {   // adds +0.0 below: exact
        e2[q] = T(0);
        e2[kTP + q] = T(0);
        continue;
      }
      T lap, xv;
      explicit_at(NS - 1, y3, p, lap, xv);
      const T ksu = lap + kiu[m];
      const T ksv = Stim::kOn ? xv + kiv[m] : kiv[m];
      const T fu = nu[m] + hb[NS - 1] * ksu;
      const T fv = nv[m] + hb[NS - 1] * ksv;
      const T gu = eu[m] + hd[NS - 1] * ksu;
      const T gv = ev[m] + hd[NS - 1] * ksv;
      const size_t g = at(p);
      y_new[g] = fu;
      y_new[plane + g] = fv;
      if (!o.counted(ly, lx)) {    // a pad cell of a padded mesh
        e2[q] = T(0);
        e2[kTP + q] = T(0);
        continue;
      }
      const T au = gu * wu[m], av = gv * wv[m];
      e2[q] = au * au;
      e2[kTP + q] = av * av;
    }
  };
  if (o.inner)
    step(std::true_type{});
  else
    step(std::false_type{});
  __syncthreads();

  // the partial sum in the one-pass block's order: its 256 threads add
  // their Newton points of each stage in the strided order over the
  // stage's region, restricted to the tile, then their tile points; the
  // others add +0.0 (exact)
  T acc = T(0);
  if (t < kImexSumThreads) {
    T dacc = T(0);
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      const int w = W - 2 * s, r = R - 2 * s;
      for (int q = t; q < w * r; q += kImexSumThreads) {
        const int ty = s + q / w - kImexHalo, tx = s + q % w - kImexHalo;
        if (ty < 0 || ty >= TileY || tx < 0 || tx >= kTile) continue;
        const int i = ty * kTile + tx;
        dacc = dacc + dy2[(2 * s - 2) * kTP + i];
        dacc = dacc + dy2[(2 * s - 1) * kTP + i];
      }
    }
    for (int q = t; q < kTP; q += kImexSumThreads) {
      acc = acc + e2[q];
      acc = acc + e2[kTP + q];
    }
    acc = acc + static_cast<T>(kImexNewtonPenalty) * dacc;
  }
  store_block_sum<T, kT>(acc, warp_sums, ss);
}

template <typename T, int TileY>
constexpr size_t imex_slots_smem() {
  return static_cast<size_t>(ImexPlan<TileY>::kElements) * sizeof(T);
}

// The kernel of `kinetics` for a Grid, T, TileY and Stim
template <class Grid, typename T, int TileY, class Stim = NoStim>
auto imex_slots_kernel(int kinetics) {
  return kinetics == kFhn
             ? &fused_imex_slots_kernel<kFhn, Grid, T, TileY, Stim>
         : kinetics == kGoldbeter
             ? &fused_imex_slots_kernel<kGoldbeter, Grid, T, TileY, Stim>
             : &fused_imex_slots_kernel<kAlievPanfilov, Grid, T, TileY,
                                        Stim>;
}

// Launch one step of fused_imex_slots_kernel over ny x nx points of `grid`
// on `stream` with the kinetics `kinetics`, on 32 x TileY tiles; returns
// the CUDA error code (0 on success), checked right after the launch. A
// tableau of another zero pattern than the kernel's is refused. stim: the
// structured forcing (StimTable) or NoStim.
template <class Grid, typename T, int TileY, class Stim = NoStim>
int launch_imex_slots(Grid grid, const void* y, void* y_new, void* ss,
                      const void* h, const void* fz, const RhsConstants<T>& k,
                      int kinetics, int ny, int nx, const ImexTable& table,
                      double rtol, double atol, void* stream,
                      Stim stim = Stim{}) {
  ImexCoeffs<T> tab;
  if (ny < 1 || nx < 1 || !valid_kinetics(kinetics)
      || !imex_slots_take(table, &tab))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = imex_slots_kernel<Grid, T, TileY, Stim>(kinetics);
  const size_t smem = imex_slots_smem<T, TileY>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((nx + kImexTile - 1) / kImexTile,
                    (ny + TileY - 1) / TileY);
  kernel<<<blocks, kImexSlotThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz), k, grid, tab,
      static_cast<T>(rtol), static_cast<T>(atol), stim);
  return static_cast<int>(cudaGetLastError());
}

// out[0] the resident blocks an SM, out[1] the registers a thread, out[2]
// the shared bytes a block (static and dynamic) of the kernel of
// `kinetics` for a Grid, T and TileY; returns the CUDA error code.
template <class Grid, typename T, int TileY>
int imex_slots_info(int kinetics, int* out) {
  if (!valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = imex_slots_kernel<Grid, T, TileY>(kinetics);
  const size_t smem = imex_slots_smem<T, TileY>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, kImexSlotThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

// Solve m x = r at a point, n <= 3 variables: Cramer, in the order of the
// torch path's integrate/imex.py::solve_pointwise (the 2x2 one
// imex_newton's)
template <int N, typename T>
__device__ __forceinline__ void solve_n(const T (&m)[N][N], const T* r,
                                        T* x) {
  if constexpr (N == 2) {
    const T det = m[0][0] * m[1][1] - m[0][1] * m[1][0];
    x[0] = (m[1][1] * r[0] - m[0][1] * r[1]) / det;
    x[1] = (m[0][0] * r[1] - m[1][0] * r[0]) / det;
  } else {
    static_assert(N == 3, "two or three variables");
    const T c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1];
    const T c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2];
    const T c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0];
    const T det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02;
    const T c10 = m[0][2] * m[2][1] - m[0][1] * m[2][2];
    const T c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0];
    const T c12 = m[0][1] * m[2][0] - m[0][0] * m[2][1];
    const T c20 = m[0][1] * m[1][2] - m[0][2] * m[1][1];
    const T c21 = m[0][2] * m[1][0] - m[0][0] * m[1][2];
    const T c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0];
    x[0] = (c00 * r[0] + c10 * r[1] + c20 * r[2]) / det;
    x[1] = (c01 * r[0] + c11 * r[1] + c21 * r[2]) / det;
    x[2] = (c02 * r[0] + c12 * r[1] + c22 * r[2]) / det;
  }
}

// imex_newton for a family of any shape: Y = rk + (h gamma) f_im(Y) from
// the predictor Y, the last update in d (imex_stages_reference's
// arithmetic: m = I - hg J, resid = (Y - hg f) - rk, d = solve(m, -resid))
template <int Kin, typename T, int N = Family<Kin>::kNv>
__device__ __forceinline__ void imex_newton_n(T hg, const T* rk, T b,
                                              T live, bool freeze, T* Y,
                                              T* d) {
#pragma unroll
  for (int v = 0; v < N; ++v) d[v] = T(0);
#pragma unroll 1
  for (int it = 0; it < kImexNewtonIters; ++it) {
    T j[N][N], f[N], m[N][N], r[N];
    jacobian_n<Kin>(Y, b, j);
    kinetics_n<Kin>(Y, b, f);
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const T jac = freeze ? j[a][c] * live : j[a][c];
        m[a][c] = (a == c ? T(1) : T(0)) - hg * jac;
      }
      const T fa = freeze ? f[a] * live : f[a];
      r[a] = -((Y[a] - hg * fa) - rk[a]);
    }
    solve_n<N>(m, r, d);
#pragma unroll
    for (int v = 0; v < N; ++v) Y[v] = Y[v] + d[v];
  }
}

// The plan of the families' kernel (fused_imex_slots_n_kernel) on 32 x
// TileY tiles: ImexPlan's region, slots and rings, with y0 and two stage
// planes of each diffusing variable and the staged terms of every
// variable (ops/fused_imex.py::slots_bytes with nvars and ndiff)
template <int Kin, int TileY>
struct ImexFamilyPlan {
  using Plan = ImexPlan<TileY>;
  static constexpr int kNv = Family<Kin>::kNv;
  static constexpr int kNd = Family<Kin>::kNd;
  static constexpr int kElements =
      3 * kNd * Plan::kRegion + kNv * kImexStages * Plan::kTilePoints;
};

// fused_imex_slots_kernel for the families of any shape (the
// NEW_FAMILIES, unforced; K3 on the periodic grid, K10 on a shard's block
// in its halo, the grid policy a template parameter as the base kernel's):
// the same tiles, slots, Newton rings, stage order and partial sums, with
// every variable of a slot's pointwise state in its thread's registers, y0
// and the stage value of each diffusing variable in shared planes, the
// explicit part the profile operator on each diffusing variable times its
// ratio (0 on the others, never formed), and the Newton on the family's
// closed-form Jacobian (imex_newton_n: 2x2 or 3x3). The staged terms are
// added variable by variable, a mirror-pad cell's as +0.0.
template <int Kin, class Grid, typename T, int TileY>
__global__ void __launch_bounds__(kImexSlotThreads, (kImexMinBlocks<T>))
    fused_imex_slots_n_kernel(const T* __restrict__ y,
                              T* __restrict__ y_new, T* __restrict__ ss,
                              const T* __restrict__ h_ptr,
                              const T* __restrict__ fz_ptr,
                              RhsConstants<T> k, Grid grid,
                              ImexCoeffs<T> tab, T rtol, T atol) {
  using Fam = Family<Kin>;
  using Plan = ImexPlan<TileY>;
  constexpr int NV = Fam::kNv;
  constexpr int ND = Fam::kNd;
  constexpr int NS = kImexStages;
  constexpr int W = Plan::kW;
  constexpr int R = Plan::kR;
  constexpr int kL = Plan::kRegion;
  constexpr int kTile = kImexTile;
  constexpr int kTP = Plan::kTilePoints;
  constexpr int kTS = Plan::kTileSlots;
  constexpr int kT = kImexSlotThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kT / 32];
  __shared__ T hae[NS][NS], hai[NS][NS], hb[NS], hd[NS];
  __shared__ T colc[3][W], rowc[2][R];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  // y0 of diffusing variable i: plane i; the stage value's: stages 1, 3 in
  // buffer 0, stage 2 in buffer 1
  const auto y0p = [&](int i) { return smem + i * kL; };
  const auto ysp = [&](int buf, int i) {
    return smem + ((1 + buf) * ND + i) * kL;
  };
  // the staged terms: dy2[((s - 1) NV + v) kTP + q], e2[v kTP + q]
  T* const dy2 = smem + 3 * ND * kL;
  T* const e2 = dy2 + (NS - 1) * NV * kTP;
  const SlotOrigin<Grid> o(grid, blockIdx.y * TileY, blockIdx.x * kTile,
                           kImexHalo, W, R);
  const size_t plane = o.plane();
  const T h = *h_ptr;
  const T fz = k.has_freeze ? *fz_ptr : T(0);
  const T hg = h * tab.gamma;
  const bool freeze = k.has_freeze != 0;
  if (threadIdx.x < NS) {
    const int s = threadIdx.x;
    for (int j = 0; j < s; ++j) {
      hae[s][j] = h * tab.ae[s][j];
      hai[s][j] = h * tab.ai[s][j];
    }
    hb[s] = h * tab.b[s];
    hd[s] = h * tab.d[s];
  }
  const int t = threadIdx.x;
  constexpr int kD1 = Plan::ring_size(1);
  constexpr int kD2 = kD1 + Plan::ring_size(2);
  const int ring_depth = t < kD1 ? 1 : t < kD2 ? 2 : t < Plan::kRing ? 3 : 0;
  const int ring_p = Plan::ring_point(
      ring_depth > 0 ? ring_depth : 1,
      t < kD1 ? t : t < kD2 ? t - kD1 : t < Plan::kRing ? t - kD2 : 0);

  const auto step = [&](auto inner) {
    constexpr bool kIn = decltype(inner)::value;
    const auto at = [&](int p) {
      return static_cast<size_t>(o.template row<kIn>(p / W)) * o.ld()
             + o.template col<kIn>(p % W);
    };
    constexpr int S = kTS + 1;
    int pt[S];
#pragma unroll
    for (int m = 0; m < kTS; ++m)
      pt[m] = (kImexHalo + (t >> 5) + m * (kT / kTile)) * W + kImexHalo
              + (t & 31);
    pt[kTS] = ring_p;
    const auto live_slot = [&](int m, int depth) {
      return m < kTS || ring_depth >= depth;
    };
    if (t < W) {
      const int c = k.torus ? o.template col<kIn>(t) : 0;
      colc[0][t] = k.c0[c];
      colc[1][t] = k.c1[c];
      colc[2][t] = k.c2[c];
    } else if (t >= 64 && t < 64 + R) {
      const int r = o.template row<kIn>(t - 64);
      rowc[0][t - 64] = beta_at(k, r);
      rowc[1][t - 64] = freeze ? live_at(k, fz, r) : T(1);
    }
    // the explicit part of diffusing variable i at local point p on its
    // plane su: the operator, times the ratio, times live
    const auto explicit_at = [&](int i, const T* su, int p) {
      const int lx = p % W;
      T lap = profile_lap_of(colc[0][lx], colc[1][lx], colc[2][lx],
                             k.torus != 0, su, p, W);
      if (Fam::ratio(i) != 1.0) lap = static_cast<T>(Fam::ratio(i)) * lap;
      return freeze ? lap * rowc[1][p / W] : lap;
    };
    // the step's start: the diffusing variables on the region, the outer
    // ring by the first kOuter threads, the slots' points by their own
    if (t < Plan::kOuter) {
      const int p = Plan::ring_point(0, t);
      const size_t g = at(p);
#pragma unroll
      for (int i = 0; i < ND; ++i) y0p(i)[p] = y[Fam::var(i) * plane + g];
    }
    T x0[S][NV];
#pragma unroll
    for (int m = 0; m < S; ++m) {
#pragma unroll
      for (int v = 0; v < NV; ++v) x0[m][v] = T(0);
      if (!live_slot(m, 1)) continue;
      const size_t g = at(pt[m]);
#pragma unroll
      for (int v = 0; v < NV; ++v) x0[m][v] = y[v * plane + g];
#pragma unroll
      for (int i = 0; i < ND; ++i) y0p(i)[pt[m]] = x0[m][Fam::var(i)];
    }
    __syncthreads();

    // rhs_known of stages 1..3, the predictor's kI, and on the tile the
    // weights and the update's and the error's sums
    T rk[S][NS - 1][NV], ki[S][NV];
    T wt[kTS][NV], nw[kTS][NV], er[kTS][NV];
    // stage 0: kE_0 = f_ex(y0), kI_0 = f_im(y0)
#pragma unroll
    for (int m = 0; m < S; ++m) {
      if (!live_slot(m, 1)) continue;
      const int p = pt[m];
      const int ly = p / W;
      T ke[NV], f[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) ke[v] = T(0);
#pragma unroll
      for (int i = 0; i < ND; ++i)
        ke[Fam::var(i)] = explicit_at(i, y0p(i), p);
      kinetics_n<Kin>(x0[m], rowc[0][ly], f);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (freeze) f[v] = f[v] * rowc[1][ly];
        const bool diff = family_diffuses<Kin>(v);
#pragma unroll
        for (int s = 1; s < NS; ++s) {
          rk[m][s - 1][v] = diff ? x0[m][v] + hae[s][0] * ke[v] : x0[m][v];
          rk[m][s - 1][v] = rk[m][s - 1][v] + hai[s][0] * f[v];
        }
        ki[m][v] = f[v];
        if (m < kTS) {
          wt[m][v] = T(1) / (rtol * fabs(x0[m][v]) + atol);
          const T ks = diff ? ke[v] + f[v] : f[v];
          nw[m][v] = x0[m][v] + hb[0] * ks;
          er[m][v] = T(0) + hd[0] * ks;
        }
      }
    }

    // implicit stages s = 1..3, each followed by its explicit evaluation
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      const int buf = (s - 1) & 1;
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (!live_slot(m, s)) continue;
        const int p = pt[m];
        const int ly = p / W;
        T Y[NV], d[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) Y[v] = rk[m][s - 1][v] + hg * ki[m][v];
        imex_newton_n<Kin>(hg, rk[m][s - 1], rowc[0][ly], rowc[1][ly],
                           freeze, Y, d);
#pragma unroll
        for (int i = 0; i < ND; ++i) ysp(buf, i)[p] = Y[Fam::var(i)];
#pragma unroll
        for (int v = 0; v < NV; ++v) ki[m][v] = (Y[v] - rk[m][s - 1][v]) / hg;
        if (m < kTS) {
          const int q = t + kT * m;
          const int lx = p % W;
          const bool on = o.in_block(ly, lx) && o.counted(ly, lx);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const T sv = d[v] * wt[m][v];
            dy2[((s - 1) * NV + v) * kTP + q] = on ? sv * sv : T(0);
          }
        }
      }
      __syncthreads();
      if (s == NS - 1) break;
      // kE_s on the slots, into the later stages' rhs_known and the sums
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (!live_slot(m, s + 1)) continue;
        const int p = pt[m];
        T ke[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) ke[v] = T(0);
#pragma unroll
        for (int i = 0; i < ND; ++i)
          ke[Fam::var(i)] = explicit_at(i, ysp(buf, i), p);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const bool diff = family_diffuses<Kin>(v);
#pragma unroll
          for (int r = s + 1; r < NS; ++r) {
            if (diff) rk[m][r - 1][v] = rk[m][r - 1][v] + hae[r][s] * ke[v];
            rk[m][r - 1][v] = rk[m][r - 1][v] + hai[r][s] * ki[m][v];
          }
          if (m < kTS) {
            const T ks = diff ? ke[v] + ki[m][v] : ki[m][v];
            nw[m][v] = nw[m][v] + hb[s] * ks;
            er[m][v] = er[m][v] + hd[s] * ks;
          }
        }
      }
    }

    // kE_3, y_new and the error on the tile
    constexpr int kBuf = (NS - 2) & 1;
#pragma unroll
    for (int m = 0; m < kTS; ++m) {
      const int p = pt[m];
      const int q = t + kT * m;
      const int ly = p / W, lx = p % W;
      if (!o.in_block(ly, lx)) {   // adds +0.0 below: exact
#pragma unroll
        for (int v = 0; v < NV; ++v) e2[v * kTP + q] = T(0);
        continue;
      }
      T ke[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) ke[v] = T(0);
#pragma unroll
      for (int i = 0; i < ND; ++i)
        ke[Fam::var(i)] = explicit_at(i, ysp(kBuf, i), p);
      const size_t g = at(p);
      const bool counted = o.counted(ly, lx);   // not a mirror-pad cell
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T ks = family_diffuses<Kin>(v) ? ke[v] + ki[m][v] : ki[m][v];
        y_new[v * plane + g] = nw[m][v] + hb[NS - 1] * ks;
        const T a = (er[m][v] + hd[NS - 1] * ks) * wt[m][v];
        e2[v * kTP + q] = counted ? a * a : T(0);
      }
    }
  };
  if (o.inner)
    step(std::true_type{});
  else
    step(std::false_type{});
  __syncthreads();

  // the partial sum in the one-pass block's order, variable by variable
  T acc = T(0);
  if (t < kImexSumThreads) {
    T dacc = T(0);
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      const int w = W - 2 * s, r = R - 2 * s;
      for (int q = t; q < w * r; q += kImexSumThreads) {
        const int ty = s + q / w - kImexHalo, tx = s + q % w - kImexHalo;
        if (ty < 0 || ty >= TileY || tx < 0 || tx >= kTile) continue;
        const int i = ty * kTile + tx;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          dacc = dacc + dy2[((s - 1) * NV + v) * kTP + i];
      }
    }
    for (int q = t; q < kTP; q += kImexSumThreads)
#pragma unroll
      for (int v = 0; v < NV; ++v) acc = acc + e2[v * kTP + q];
    acc = acc + static_cast<T>(kImexNewtonPenalty) * dacc;
  }
  store_block_sum<T, kT>(acc, warp_sums, ss);
}

// Launch one step of fused_imex_slots_n_kernel<Kin, Grid, T, TileY> over
// ny x nx points (the grid's, or the shard's block) on `stream`; a tableau
// of another zero pattern than the kernel's is refused. Returns the CUDA
// error code (0 on success).
template <int Kin, typename T, int TileY, class Grid>
int launch_imex_slots_n(Grid grid, const void* y, void* y_new, void* ss,
                        const void* h, const void* fz,
                        const RhsConstants<T>& k, int ny, int nx,
                        const ImexTable& table, double rtol, double atol,
                        void* stream) {
  ImexCoeffs<T> tab;
  if (ny < 1 || nx < 1 || !imex_slots_take(table, &tab))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = &fused_imex_slots_n_kernel<Kin, Grid, T, TileY>;
  const size_t smem =
      static_cast<size_t>(ImexFamilyPlan<Kin, TileY>::kElements) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((nx + kImexTile - 1) / kImexTile,
                    (ny + TileY - 1) / TileY);
  kernel<<<blocks, kImexSlotThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz), k, grid, tab,
      static_cast<T>(rtol), static_cast<T>(atol));
  return static_cast<int>(cudaGetLastError());
}

// imex_slots_info of fused_imex_slots_n_kernel<Kin, Grid, T, TileY>
template <int Kin, class Grid, typename T, int TileY>
int imex_slots_n_info(int* out) {
  auto kernel = &fused_imex_slots_n_kernel<Kin, Grid, T, TileY>;
  const size_t smem =
      static_cast<size_t>(ImexFamilyPlan<Kin, TileY>::kElements) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, kImexSlotThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

}  // namespace crd
