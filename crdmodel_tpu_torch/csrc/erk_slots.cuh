// The register-resident tile scheme of the port's fused embedded-ERK step
// kernels on the 5-point profile operator, the face-coefficient operators
// and the 2-D tensor: K1, K4 and K5 (fused_step.cu, fused_divform.cu,
// fused_aniso.cu, the periodic grid, WrapGrid) and K8 and K11
// (fused_shard_step.cu, fused_shard_divform.cu, one shard's block in the
// halo the exchange filled, HaloGrid), each through a functor with a
// "coefficients read once" entry (rhs_common.cuh::ProfileRhs, DivformRhs,
// MixedDivformRhs, AnisoRhs: Point, point(), at_point(), plane()).
//
// One launch performs a whole step, as erk_tile.cuh's kernel does, on the
// same tiles (ops/fused_step.py::tile_plan: 32 x tile_y with n rings), and
// writes the same y_new and the same partial sums, bit for bit. What differs
// is where the values live. A block of kSlotThreads threads owns a tile; its
// threads are fixed to the points of the tile and its first n - 1 rings
// (tile_slots.cuh::SlotRegion, a region compile-time in both axes), each
// thread to kSlots of them, for the whole launch. A point's stage inputs to
// come and its error accumulate in its thread's registers as each stage k_s
// is formed, in the plain version's order (erk_tile.cuh:146-159), and its
// coefficients (the operator's Point: the three profiles at its column, or
// aE, aW, aN, aS and the tissue field or the mixed weight; beta and live
// of its row) are read from device memory once, not once an evaluation.
// Only the stage input's variable 0, which the stencil reads at
// neighbours, goes through shared memory: two planes on the tile and its n
// rings (the outer ring feeds only the first stage's stencil, from the
// step's start, and is loaded by threads of its own, so that every load of
// the step's start is issued before one barrier), one block barrier a
// stage; an operator that reads a coefficient at neighbours (the mixed
// pair's Dxy, the tensor's dxyw) holds it in a plane of its own. Every
// stage before the last runs at every point of the slots, the rings whose
// values no longer matter included, so the slots' code has no branches;
// the last runs on the tile.
//
// The scheme takes an FSAL tableau of kSlotStages stages (bs32): its last
// stage's input is the update (a[n-1] == b), so y_new is that input and
// needs no accumulator of its own. The launcher (launch_erk_slots_on)
// dispatches on the stage count: other tableaus (zonneveld43, dopri54) go
// to erk_tile.cuh's kernel. The grid policy enters at compile time
// (SlotOrigin): a tile whose region lies inside the grid (WrapGrid) or
// inside the shard's buffer (HaloGrid) takes code without the wrap or the
// clamp; the others wrap by loops or clamp. The squared errors of the
// tile's points pass through shared memory, so that each partial sum adds
// them in erk_tile.cuh's 256-thread order (store_block_sum): the partial
// sums are erk_tile.cuh's, and a run takes the same steps.
//
// A structured forcing (K1 and K4: Stim = StimTable, rhs_common.cuh) adds
// stimulus j's (amps[j][s] * rows[j][r]) * cols[j][c] to stage s's
// right-hand side at each slot, (r, c) the row and column indices the
// slot's state is loaded from (the wrapped ones on a ring of the periodic
// grid), kept in the thread's registers beside the point's coefficients;
// the amplitudes and the profiles are read through the read-only data
// cache. Stim = NoStim compiles it out: the unforced kernels are the ones
// before it.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "erk_tile.cuh"
#include "rhs_common.cuh"
#include "tile_slots.cuh"

namespace crd {

constexpr int kSlotThreads = 512;   // ops/erk_slots.py THREADS
constexpr int kSlotStages = 4;      // the tableau the scheme takes: bs32
constexpr int kSlotTileX = 32;      // ops/fused_step.py TILE_X
constexpr int kSlotTileY = 32;      // tile_plan's tile_y for bs32

// The block's region: the tile and kSlotStages rings (the stage planes,
// kRegW x kRegR points), and the slots on all of it but the outer ring
template <int TileY>
struct SlotPlan {
  static constexpr int kRegW = kSlotTileX + 2 * kSlotStages;
  static constexpr int kRegR = TileY + 2 * kSlotStages;
  static constexpr int kRegion = kRegW * kRegR;
  using Slots = SlotRegion<kRegW - 2, kRegR - 2, kSlotThreads>;
  static constexpr int kTile = kSlotTileX * TileY;
  static constexpr int kRing = 2 * (kRegW + kRegR) - 4;   // the outer ring

  // the local index of the outer ring's point i
  static __device__ __forceinline__ int ring(int i) {
    if (i < kRegW) return i;                                  // first row
    if (i < 2 * kRegW) return (kRegR - 1) * kRegW + i - kRegW;   // last
    const int r = (i - 2 * kRegW) % (kRegR - 2) + 1;
    return r * kRegW + (i < 2 * kRegW + kRegR - 2 ? 0 : kRegW - 1);
  }

  // dynamic shared memory (in T): the two stage planes, the operator's
  // planes and the tile's squared errors of both variables
  // (ops/erk_slots.py::slots_plan)
  static constexpr int elements(int op_planes) {
    return (2 + op_planes) * kRegion + 2 * kTile;
  }
};

// bs32 in f32, the main path's: two blocks an SM (at most 64 registers)
template <typename T>
constexpr int kSlotMinBlocks = sizeof(T) == 4 ? 2 : 1;

// ny x nx is the extent the tiles cover: the grid's, or the shard's block.
template <class Op, class Grid, typename T, int TileY, class Stim>
__global__ void __launch_bounds__(kSlotThreads, (kSlotMinBlocks<T>))
    fused_erk_slots_kernel(const T* __restrict__ y, T* __restrict__ y_new,
                           T* __restrict__ ss, const T* __restrict__ h_ptr,
                           const T* __restrict__ fz_ptr, Op op, Grid grid,
                           StageTable tab, T rtol, T atol, Stim stim) {
  using Plan = SlotPlan<TileY>;
  using Reg = typename Plan::Slots;
  static_assert(Plan::kRing <= kSlotThreads, "a thread a ring point");
  constexpr int NS = kSlotStages;
  constexpr int kW = Plan::kRegW;
  constexpr int kL = Plan::kRegion;
  constexpr int S = Reg::kSlots;
  constexpr int kTile = Plan::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kSlotThreads / 32];
  T* const su[2] = {reinterpret_cast<T*>(smem_raw),
                    reinterpret_cast<T*>(smem_raw) + kL};
  T* const sx = su[1] + kL;                   // Op::kPlanes planes
  T* const e2 = sx + Op::kPlanes * kL;        // [2][kTile]
  const SlotOrigin<Grid> o(grid, blockIdx.y * TileY, blockIdx.x * kSlotTileX,
                           NS, kW, Plan::kRegR);
  const size_t plane = o.plane();
  const T h = *h_ptr;
  const T fz = *fz_ptr;

  // the step on the tile; kIn: the region lies inside the grid
  const auto step = [&](auto inner) {
    constexpr bool kIn = decltype(inner)::value;
    // the step's start, its loads all issued before one barrier: u on the
    // region into both stage planes (the second's outer ring stays as
    // loaded, read only by points whose values no longer matter) and the
    // operator's planes, the outer ring by the first kRing threads, the
    // slots' points by their own threads
    const auto load = [&](int i, int ly, int lx) {
      const size_t g = static_cast<size_t>(o.template row<kIn>(ly)) * o.ld()
                       + o.template col<kIn>(lx);
      const T u = y[g];
      su[0][i] = u;
      su[1][i] = u;
#pragma unroll
      for (int j = 0; j < Op::kPlanes; ++j) sx[j * kL + i] = op.plane(j, g);
      return u;
    };
    if (threadIdx.x < Plan::kRing) {
      const int i = Plan::ring(threadIdx.x);
      load(i, i / kW, i - (i / kW) * kW);
    }
    // the slots: local point, coefficients, the stage inputs 1 .. NS - 1
    // (in[s - 1], y0 until the stages before add to them) and the error
    T inu[NS - 1][S], inv[NS - 1][S];
    T eu[S], ev[S];
    typename Op::Point cf[S];
    int sr[S], sc[S];   // the forcing's row and column indices
    const auto local = [](int m) {   // slot m's index on the region
      const int q = Reg::point(m);
      return (Reg::row(q) + 1) * kW + Reg::col(q) + 1;
    };
    // k_s at slot m on the stage input `in` (v the slot's variable 1)
    const auto rhs = [&](int s, int m, const T* in, T v, T& du, T& dv) {
      if constexpr (Stim::kOn) {
        T fu, fv;
        stim.at(s, sr[m], sc[m], fu, fv);
        op.at_point(cf[m], sx, in, v, local(m), kW, fu, fv, du, dv);
      } else {
        op.at_point(cf[m], sx, in, v, local(m), kW, du, dv);
      }
    };
#pragma unroll
    for (int m = 0; m < S; ++m) {
      if (!Reg::valid(m)) continue;
      const int q = Reg::point(m);
      const int ly = Reg::row(q) + 1, lx = Reg::col(q) + 1;
      const int r = o.template row<kIn>(ly), c = o.template col<kIn>(lx);
      const size_t g = static_cast<size_t>(r) * o.ld() + c;
      const size_t gs = static_cast<size_t>(o.template row<kIn>(ly - 1))
                        * o.ld() + c;
      const T u0 = load(local(m), ly, lx), v0 = y[plane + g];
#pragma unroll
      for (int s = 0; s < NS - 1; ++s) {
        inu[s][m] = u0;
        inv[s][m] = v0;
      }
      eu[m] = T(0);
      ev[m] = T(0);
      cf[m] = op.point(fz, g, gs, r, c);
      if constexpr (Stim::kOn) {
        sr[m] = r;
        sc[m] = c;
      }
    }
    __syncthreads();
    // stage s is right on the points s or more rings inside the slots
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      const T* const in = su[s & 1];
      if (s > 0) {
        // stage s's input u, once every thread is past the stage that
        // read this plane last
#pragma unroll
        for (int m = 0; m < S; ++m)
          if (Reg::valid(m)) su[s & 1][local(m)] = inu[s - 1][m];
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (!Reg::valid(m)) continue;
        // stage 0's input is y0, whose v every in[] still holds
        const T v = inv[s > 0 ? s - 1 : 0][m];
        T du, dv;
        rhs(s, m, in, v, du, dv);
        // k_s into the inputs of the stages after it and the error, each
        // in stage order
#pragma unroll
        for (int t = s + 1; t < NS; ++t) {
          if (tab.a[t][s] != 0.0) {
            const T ha = h * static_cast<T>(tab.a[t][s]);
            inu[t - 1][m] = inu[t - 1][m] + ha * du;
            inv[t - 1][m] = inv[t - 1][m] + ha * dv;
          }
        }
        if (tab.d[s] != 0.0) {
          const T hd = h * static_cast<T>(tab.d[s]);
          eu[m] = eu[m] + hd * du;
          ev[m] = ev[m] + hd * dv;
        }
      }
    }
    // the last stage on the tile: its input is y_new (FSAL)
    constexpr int kLast = NS - 1;
    T* const last = su[kLast & 1];
#pragma unroll
    for (int m = 0; m < S; ++m)
      if (Reg::valid(m)) last[local(m)] = inu[kLast - 1][m];
    __syncthreads();
#pragma unroll
    for (int m = 0; m < S; ++m) {
      const int q = Reg::point(m);
      if (!Reg::valid(m) || !Reg::inside(q, kLast)) continue;
      const int ly = Reg::row(q) + 1, lx = Reg::col(q) + 1;
      const int t = (ly - NS) * kSlotTileX + lx - NS;
      if (!o.in_block(ly, lx)) {   // adds +0.0: exact, as erk_tile's skip
        e2[t] = T(0);
        e2[kTile + t] = T(0);
        continue;
      }
      const T nu = inu[kLast - 1][m], nv = inv[kLast - 1][m];
      T du, dv;
      rhs(kLast, m, last, nv, du, dv);
      T fu = eu[m], fv = ev[m];
      if (tab.d[kLast] != 0.0) {
        const T hd = h * static_cast<T>(tab.d[kLast]);
        fu = fu + hd * du;
        fv = fv + hd * dv;
      }
      const size_t g = static_cast<size_t>(o.template row<kIn>(ly)) * o.ld()
                       + o.template col<kIn>(lx);
      y_new[g] = nu;
      y_new[plane + g] = nv;
      if (!o.counted(ly, lx)) {    // a pad cell of a padded mesh
        e2[t] = T(0);
        e2[kTile + t] = T(0);
        continue;
      }
      const T wu = fu * (T(1) / (rtol * fabs(y[g]) + atol));
      const T wv = fv * (T(1) / (rtol * fabs(y[plane + g]) + atol));
      e2[t] = wu * wu;
      e2[kTile + t] = wv * wv;
    }
  };
  if (o.inner)
    step(std::true_type{});
  else
    step(std::false_type{});
  __syncthreads();
  // the partial sum in erk_tile.cuh's order: its 256 threads add their
  // points' squares in turn; the others add +0.0 (exact)
  T acc = T(0);
  if (threadIdx.x < kErkThreads) {
    for (int t = threadIdx.x; t < kTile; t += kErkThreads) {
      acc = acc + e2[t];
      acc = acc + e2[kTile + t];
    }
  }
  store_block_sum<T, kSlotThreads>(acc, warp_sums, ss);
}

// The scheme takes the tableau: kSlotStages stages, FSAL (ops/erk_slots.py::
// uses_slots).
inline bool slots_take(const StageTable& tab) {
  return tab.n == kSlotStages && stage_table_is_fsal(tab);
}

template <class Op, class Grid, typename T>
size_t slots_smem_bytes() {
  return static_cast<size_t>(SlotPlan<kSlotTileY>::elements(Op::kPlanes))
         * sizeof(T);
}

// Launch one step over ny x nx points on `stream`: fused_erk_slots_kernel
// for a tableau the scheme takes (slots_take, on K1's 32 x 32 tiles),
// erk_tile.cuh's kernel for the others; stim: the structured forcing
// (StimTable) or NoStim; returns the CUDA error code (0 on success),
// checked right after the launch.
template <class Op, typename T, class Grid, class Stim = NoStim>
int launch_erk_slots_on(Op op, Grid grid, const void* y, void* y_new,
                        void* ss, const void* h, const void* fz, int ny,
                        int nx, int tile_x, int tile_y, const StageTable& tab,
                        double rtol, double atol, void* stream,
                        Stim stim = Stim{}) {
  if (!slots_take(tab))
    return launch_erk_tile_on<Op, T>(op, grid, y, y_new, ss, h, fz, ny, nx,
                                     tile_x, tile_y, tab, rtol, atol,
                                     stream, stim);
  if (ny < 1 || nx < 1 || tile_x != kSlotTileX || tile_y != kSlotTileY)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slots_smem_bytes<Op, Grid, T>();
  auto kernel = &fused_erk_slots_kernel<Op, Grid, T, kSlotTileY, Stim>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((nx + kSlotTileX - 1) / kSlotTileX,
                    (ny + kSlotTileY - 1) / kSlotTileY);
  kernel<<<blocks, kSlotThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz), op, grid, tab,
      static_cast<T>(rtol), static_cast<T>(atol), stim);
  return static_cast<int>(cudaGetLastError());
}

// out[0] the resident blocks an SM, out[1] the registers a thread, out[2]
// the shared bytes a block (static and dynamic) of
// fused_erk_slots_kernel<Op, Grid, T> (unforced); returns the CUDA error
// code.
template <class Op, class Grid, typename T>
int slots_kernel_info(int* out) {
  auto kernel = &fused_erk_slots_kernel<Op, Grid, T, kSlotTileY, NoStim>;
  const size_t smem = slots_smem_bytes<Op, Grid, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                        kSlotThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

// The scheme for the families of any shape (FamilyRhs: the NEW_FAMILIES,
// unforced, on the periodic grid for K1 and on a shard's block in its halo
// for K8, the grid policy a template parameter as the base kernel's): the
// tiles, slots, stage order and partial sums of fused_erk_slots_kernel,
// with every variable of a slot's stage inputs and error in its thread's
// registers and a pair of shared stage planes for each diffusing variable
// (Family<Kin>::kNd pairs); the squared errors are added variable by
// variable, a mirror-pad cell's as +0.0.
template <int Kin>
struct SlotFamilyPlan {
  // dynamic shared memory (in T): two stage planes a diffusing variable,
  // the tile's squared errors of every variable
  static constexpr int elements() {
    return 2 * Family<Kin>::kNd * SlotPlan<kSlotTileY>::kRegion
           + Family<Kin>::kNv * SlotPlan<kSlotTileY>::kTile;
  }
};

template <int Kin, class Grid, typename T>
__global__ void __launch_bounds__(kSlotThreads, (kSlotMinBlocks<T>))
    fused_erk_slots_n_kernel(const T* __restrict__ y, T* __restrict__ y_new,
                             T* __restrict__ ss, const T* __restrict__ h_ptr,
                             const T* __restrict__ fz_ptr,
                             FamilyRhs<Kin, T> op, Grid grid,
                             StageTable tab, T rtol, T atol) {
  using Fam = Family<Kin>;
  using Plan = SlotPlan<kSlotTileY>;
  using Reg = typename Plan::Slots;
  constexpr int NV = Fam::kNv;
  constexpr int ND = Fam::kNd;
  constexpr int NS = kSlotStages;
  constexpr int kW = Plan::kRegW;
  constexpr int kL = Plan::kRegion;
  constexpr int S = Reg::kSlots;
  constexpr int kTile = Plan::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kSlotThreads / 32];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  // stage plane `buf` (0, 1) of diffusing variable i
  const auto sp = [&](int buf, int i) { return smem + (buf * ND + i) * kL; };
  T* const e2 = smem + 2 * ND * kL;          // [NV][kTile]
  const SlotOrigin<Grid> o(grid, blockIdx.y * kSlotTileY,
                           blockIdx.x * kSlotTileX, NS, kW, Plan::kRegR);
  const size_t plane = o.plane();
  const T h = *h_ptr;
  const T fz = *fz_ptr;

  // the step on the tile; kIn: the region lies inside the grid
  const auto step = [&](auto inner) {
    constexpr bool kIn = decltype(inner)::value;
    const auto at = [&](int ly, int lx) {
      return static_cast<size_t>(o.template row<kIn>(ly)) * o.ld()
             + o.template col<kIn>(lx);
    };
    // the diffusing variables at grid offset g into both stage planes at
    // local point i
    const auto load = [&](int i, size_t g) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const T x = y[Fam::var(d) * plane + g];
        sp(0, d)[i] = x;
        sp(1, d)[i] = x;
      }
    };
    if (threadIdx.x < Plan::kRing) {
      const int i = Plan::ring(threadIdx.x);
      load(i, at(i / kW, i - (i / kW) * kW));
    }
    // the slots: coefficients, the stage inputs 1 .. NS - 1 (in[s - 1],
    // y0 until the stages before add to them) and the error
    T in[NS - 1][NV][S], e[NV][S];
    typename FamilyRhs<Kin, T>::Point cf[S];
    const auto local = [](int m) {   // slot m's index on the region
      const int q = Reg::point(m);
      return (Reg::row(q) + 1) * kW + Reg::col(q) + 1;
    };
    // k_s at slot m on stage input x (its variables) and stage planes buf
    const auto rhs = [&](int m, int buf, const T* x, T* dy) {
      const T* planes[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) planes[d] = sp(buf, d);
      op.at_point(cf[m], planes, x, local(m), kW, dy);
    };
#pragma unroll
    for (int m = 0; m < S; ++m) {
      if (!Reg::valid(m)) continue;
      const int q = Reg::point(m);
      const int ly = Reg::row(q) + 1, lx = Reg::col(q) + 1;
      const size_t g = at(ly, lx);
      load(local(m), g);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T x0 = y[v * plane + g];
#pragma unroll
        for (int s = 0; s < NS - 1; ++s) in[s][v][m] = x0;
        e[v][m] = T(0);
      }
      cf[m] = op.point(fz, o.template row<kIn>(ly),
                       o.template col<kIn>(lx));
    }
    __syncthreads();
    // stage s is right on the points s or more rings inside the slots
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s > 0) {
        // stage s's diffusing variables, once every thread is past the
        // stage that read these planes last
#pragma unroll
        for (int m = 0; m < S; ++m)
          if (Reg::valid(m))
#pragma unroll
            for (int d = 0; d < ND; ++d)
              sp(s & 1, d)[local(m)] = in[s - 1][Fam::var(d)][m];
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (!Reg::valid(m)) continue;
        // stage 0's input is y0, which every in[] still holds
        T x[NV], dy[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) x[v] = in[s > 0 ? s - 1 : 0][v][m];
        rhs(m, s & 1, x, dy);
        // k_s into the inputs of the stages after it and the error, each
        // in stage order
#pragma unroll
        for (int t = s + 1; t < NS; ++t) {
          if (tab.a[t][s] != 0.0) {
            const T ha = h * static_cast<T>(tab.a[t][s]);
#pragma unroll
            for (int v = 0; v < NV; ++v)
              in[t - 1][v][m] = in[t - 1][v][m] + ha * dy[v];
          }
        }
        if (tab.d[s] != 0.0) {
          const T hd = h * static_cast<T>(tab.d[s]);
#pragma unroll
          for (int v = 0; v < NV; ++v) e[v][m] = e[v][m] + hd * dy[v];
        }
      }
    }
    // the last stage on the tile: its input is y_new (FSAL)
    constexpr int kLast = NS - 1;
#pragma unroll
    for (int m = 0; m < S; ++m)
      if (Reg::valid(m))
#pragma unroll
        for (int d = 0; d < ND; ++d)
          sp(kLast & 1, d)[local(m)] = in[kLast - 1][Fam::var(d)][m];
    __syncthreads();
#pragma unroll
    for (int m = 0; m < S; ++m) {
      const int q = Reg::point(m);
      if (!Reg::valid(m) || !Reg::inside(q, kLast)) continue;
      const int ly = Reg::row(q) + 1, lx = Reg::col(q) + 1;
      const int t = (ly - NS) * kSlotTileX + lx - NS;
      if (!o.in_block(ly, lx)) {   // adds +0.0: exact, as erk_tile's skip
#pragma unroll
        for (int v = 0; v < NV; ++v) e2[v * kTile + t] = T(0);
        continue;
      }
      T x[NV], dy[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) x[v] = in[kLast - 1][v][m];
      rhs(m, kLast & 1, x, dy);
      const size_t g = at(ly, lx);
      const bool counted = o.counted(ly, lx);   // not a mirror-pad cell
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        T f = e[v][m];
        if (tab.d[kLast] != 0.0)
          f = f + (h * static_cast<T>(tab.d[kLast])) * dy[v];
        y_new[v * plane + g] = x[v];
        const T w = f * (T(1) / (rtol * fabs(y[v * plane + g]) + atol));
        e2[v * kTile + t] = counted ? w * w : T(0);
      }
    }
  };
  if (o.inner)
    step(std::true_type{});
  else
    step(std::false_type{});
  __syncthreads();
  // the partial sum in erk_tile.cuh's order: its 256 threads add their
  // points' squares in turn, variable by variable; the others add +0.0
  T acc = T(0);
  if (threadIdx.x < kErkThreads) {
    for (int t = threadIdx.x; t < kTile; t += kErkThreads)
#pragma unroll
      for (int v = 0; v < NV; ++v) acc = acc + e2[v * kTile + t];
  }
  store_block_sum<T, kSlotThreads>(acc, warp_sums, ss);
}

// Launch one step of the families' K1 or K8 over ny x nx points (the
// grid's, or the shard's block) on `stream`: fused_erk_slots_n_kernel for
// a tableau the scheme takes (slots_take, on 32 x 32 tiles), erk_tile.cuh's
// fused_erk_tile_n_kernel for the others; returns the CUDA error code (0
// on success), checked right after the launch.
template <int Kin, typename T, class Grid>
int launch_erk_slots_n(FamilyRhs<Kin, T> op, Grid grid, const void* y,
                       void* y_new, void* ss, const void* h, const void* fz,
                       int ny, int nx, int tile_x, int tile_y,
                       const StageTable& tab, double rtol, double atol,
                       void* stream) {
  if (!slots_take(tab))
    return launch_erk_tile_n<Kin, T>(op, grid, y, y_new, ss, h, fz, ny, nx,
                                     tile_x, tile_y, tab, rtol, atol,
                                     stream);
  if (ny < 1 || nx < 1 || tile_x != kSlotTileX || tile_y != kSlotTileY)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(SlotFamilyPlan<Kin>::elements()) * sizeof(T);
  auto kernel = &fused_erk_slots_n_kernel<Kin, Grid, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((nx + kSlotTileX - 1) / kSlotTileX,
                    (ny + kSlotTileY - 1) / kSlotTileY);
  kernel<<<blocks, kSlotThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz), op, grid, tab,
      static_cast<T>(rtol), static_cast<T>(atol));
  return static_cast<int>(cudaGetLastError());
}

// slots_kernel_info of fused_erk_slots_n_kernel<Kin, Grid, T>
template <int Kin, class Grid, typename T>
int slots_n_kernel_info(int* out) {
  auto kernel = &fused_erk_slots_n_kernel<Kin, Grid, T>;
  const size_t smem =
      static_cast<size_t>(SlotFamilyPlan<Kin>::elements()) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                        kSlotThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

}  // namespace crd
