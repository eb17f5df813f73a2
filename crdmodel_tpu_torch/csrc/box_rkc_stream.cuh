// The chunked z-streaming scheme of the port's fused RKC2 step kernels on
// the 3-D box: K7 (fused_box3d_rkc.cu, the whole box, StreamWrap) and K13
// (fused_shard_box3d_rkc.cu, one shard's block inside the halo the exchange
// filled, StreamHalo), on box_stream.cuh's region, rings and offsets, in
// the operator modes where it beat their persistent kernels on the H100
// (rkc_stream_take: the tensor mode).
//
// A step of s Chebyshev stages (integrate/rkc.py) takes s + 1 right-hand
// side evaluations: evaluation 0 is F0 = f(y0) with Y1 = y0 + (h mu1) F0,
// evaluation e in 1..s-1 gives
//   Y_{e+1} = (1 - mu - nu) y0 + mu Y_e + nu Y_{e-1} + (h mut) f(Y_e)
//             + (h gt) F0
// (Y_0 = y0), evaluation s is F1 = f(Y_s): y_new = Y_s, the order-2 error
// estimate est = 0.8 (y0 - y_new) + (0.4 h)(F0 + F1) and partial sums of
// its squared WRMS-scaled values. They run in chunks of at most
// kStreamDepth evaluations, split evenly (ops/fused_rkc.py::chunk_schedule
// with depth kStreamDepth), one ordinary launch a chunk: the launcher
// launches ceil((s_cap + 1) / kStreamDepth) of them a step, and a launch
// whose chunk the step's s does not have returns at once (s lives on the
// device; the host never reads it).
//
// A chunk is one z-streaming pass of box_stream.cuh: one block a tile and
// z chunk, its 512 threads fixed to the region's points; evaluation i of
// the chunk runs at plane p - i in iteration p on the tile and its
// n - 1 - i rings (n the chunk's evaluations). Its input's variable 0 sits
// in ring i (three planes in shared memory), which evaluation i - 1 fills;
// ring 0 is y's variable 0 in the first chunk, the hand-on Y_e's after it.
// Y_{e-1}'s u at plane q is still in ring i - 1, slot q % 3, when
// evaluation i reaches q (evaluation i - 2 writes plane q + 2 in the same
// iteration). The pointwise values of each plane in flight stay with its
// point: the v of Y_e and Y_{e-1} in registers, lag by lag, F0's two
// variables in the thread's own shared slots, plane q in slot
// q % kStreamDepth (the tensor operator needs the registers); y0 is read
// again from y at each evaluation (a plane of 264 resident tiles is some
// 1 MB in f32, an L2 hit). More shared memory costs the
// operators' L1 reads: y0 in shared slots, and the hand-on values copied
// in asynchronously an iteration ahead, were slower at the slab's shapes
// on the H100 (PERF.md, section 6).
//
// Between chunks the grid must be complete, so the chunks are launches:
// the first chunk hands F0 and the last two stage values it formed,
// (Y_e, Y_{e-1}) in both variables, to the next through `work` (three
// states: F0, Y_e, Y_{e-1}), each tile point of its extent written by its
// own block. s <= kRkcStreamStages = 2 kStreamDepth - 1 (two chunks), so a
// launch never reads the hand-on values it writes. On a shard a chunk's
// tiles cover the block grown by the evaluations still to come after it
// (StreamHalo::extent_rings), so the block's cone lies in what the first
// chunk handed on; the last chunk's tiles are the block's. Each launch's
// grid is one-dimensional, the largest tile count any s gives its chunk;
// a block takes the tile and z chunk of its index under its chunk's plan
// (the extent's tiles, in the last chunk's z chunks: as few as bring the
// last chunk's tiles to min_tiles), tile column fastest, then row, then z
// chunk, and leaves when there is none.
//
// Only the last chunk writes y_new (the block's points) and the partial
// sums: one a tile and z chunk, each thread adding its tile point's u and
// v squares plane by plane (box_stream.cuh's order, replayed by
// ops/box_stream.py::stream_tile_sums), then store_block_sum. Every value
// follows ops/fused_rkc.py::rkc_stages_reference operation for operation,
// the library built with -fmad=false. An s outside [2, s_cap] keeps y and
// gives NaN partial sums, which the adaptive loop rejects.

#pragma once

#include <cuda_runtime.h>

#include "box_stream.cuh"

namespace crd {

// the most stages a step takes: two chunks of kStreamDepth evaluations
// (ops/fused_box3d_rkc.py C_RKC)
constexpr int kRkcStreamStages = 2 * kStreamDepth - 1;
constexpr int kRkcTableStages = 23;   // ops/fused_rkc.py S_MAX_KERNEL: ctab rows

// The operator modes that take this scheme (ops/box_stream.py::
// RKC_STREAM_MODES): the tensor mode, where it was the faster at the
// slab's shapes on the H100; K7's and K13's launchers send the others to
// their persistent kernels (PERF.md, section 6).
__host__ __device__ constexpr bool rkc_stream_take(int mode) {
  return mode == kBoxTensor;
}

// Shared bytes of the kernel (ops/box_stream.py::rkc_shared_bytes, less
// the static warp sums): the rings and offsets, and F0's two variables of
// kStreamDepth planes at every slot.
constexpr size_t rkc_stream_bytes(size_t itemsize) {
  return StreamPlan::bytes(
      itemsize, 2 * StreamPlan::kN * StreamPlan::kSlots * kStreamThreads);
}

// The evaluations [e0, e1) of chunk c of a step of s stages, and their
// number; false when the step has no chunk c.
__host__ __device__ inline bool rkc_stream_chunk(int s, int c, int& e0,
                                                 int& e1) {
  const int n_evals = s + 1;
  const int chunks = (n_evals + kStreamDepth - 1) / kStreamDepth;
  if (c >= chunks) return false;
  e0 = c * n_evals / chunks;
  e1 = (c + 1) * n_evals / chunks;
  return true;
}

// The plan of a chunk whose tiles cover grid's extent grown by `rings`:
// tiles in a row and a column, planes of a z chunk (the extent's own, the
// last chunk's, in every chunk), and the launch's tiles (tile column
// fastest, then row, then z chunk).
struct RkcStreamPlan {
  int ntx;
  int nty;
  int z_chunk;
  int tiles;
};

template <class Grid>
__host__ __device__ inline RkcStreamPlan rkc_stream_plan(const Grid& grid,
                                                         int nz, int rings,
                                                         int min_tiles) {
  RkcStreamPlan p;
  p.ntx = (grid.extent_x() + 2 * rings + kStreamTileX - 1) / kStreamTileX;
  p.nty = (grid.extent_y() + 2 * rings + kStreamTileY - 1) / kStreamTileY;
  // the z chunks of the last chunk's plan, whatever the rings
  p.z_chunk = stream_z_chunk(
      nz,
      ((grid.extent_x() + kStreamTileX - 1) / kStreamTileX)
          * ((grid.extent_y() + kStreamTileY - 1) / kStreamTileY),
      min_tiles);
  p.tiles = p.ntx * p.nty * ((nz + p.z_chunk - 1) / p.z_chunk);
  return p;
}

// One chunk (`chunk`) of a step on the tile and z chunk blockIdx.x of its
// plan; work: F0, Y_e and Y_{e-1}, each (2, nz, ny, nx). With a forcing
// (Stim a BoxStimTable), evaluation e at plane q adds its terms at
// amplitude column rkc_amp_column(e) and plane q.
template <int Mode, int Kin, class Grid, typename T, class Stim>
__global__ void __launch_bounds__(kStreamThreads, (kStreamMinBlocks<T>))
    fused_box_rkc_stream_kernel(const T* __restrict__ y,
                                T* __restrict__ y_new, T* __restrict__ ss,
                                T* work, const T* __restrict__ h_ptr,
                                const T* __restrict__ fz_ptr,
                                const int* __restrict__ s_ptr,
                                const T* __restrict__ mu1_tab,
                                const T* __restrict__ ctab, int s_cap,
                                BoxConstants<T> c, Grid grid, int chunk,
                                int min_tiles, T rtol, T atol, Stim stim) {
  using P = StreamPlan;
  constexpr int D = P::kN;
  constexpr int S = P::kSlots;
  constexpr int SE = P::kEvalSlots;
  constexpr int ST = P::kTileSlots;
  constexpr int W = P::kW;
  constexpr int L = P::kRegion;
  constexpr int NP = S * kStreamThreads;     // one value at every slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kStreamThreads / 32];
  T* const rings = reinterpret_cast<T*>(smem_raw);    // [D][3][L]
  // F0 of slot m's point on plane q, variable v: f0s[((q % D) * 2 + v)
  // * NP + threadIdx.x + kStreamThreads * m], each thread its own points'
  // (no barrier)
  T* const f0s = rings + 3 * D * L;
  int* const goff = reinterpret_cast<int*>(f0s + 2 * D * NP);
  // offsets into the state and `work`: 32-bit (the launcher checks that
  // they fit)
  using Off = int;
  const int nz = c.nz;
  const Off plane = static_cast<Off>(c.ny) * c.nx;
  const Off var1 = plane * nz;          // variable 1's offset
  const int s = *s_ptr;
  const int t = blockIdx.x;
  if (s < 2 || s > s_cap) {
    // no table row for this stage count: the first launch keeps y on the
    // block and poisons the error sums (the last chunk's plan)
    if (chunk != 0) return;
    const RkcStreamPlan plan = rkc_stream_plan(grid, nz, 0, min_tiles);
    if (t >= plan.tiles) return;
    const int in_plane = plan.ntx * plan.nty;
    const int tz = t / in_plane, ty = (t - tz * in_plane) / plan.ntx;
    const int tx = t - tz * in_plane - ty * plan.ntx;
    const int ey = ty * kStreamTileY + static_cast<int>(threadIdx.x)
                                           / kStreamTileX;
    const int ex = tx * kStreamTileX + static_cast<int>(threadIdx.x)
                                           % kStreamTileX;
    if (grid.in_extent(ey, ex, 0)) {
      const Off go = static_cast<Off>(grid.row(ey)) * c.nx + grid.col(ex);
      const int z0 = tz * plan.z_chunk;
      for (int q = z0; q < min(z0 + plan.z_chunk, nz); ++q) {
        const Off g = q * plane + go;
        y_new[g] = y[g];
        y_new[var1 + g] = y[var1 + g];
      }
    }
    if (threadIdx.x == 0) ss[t] = quiet_nan<T>();
    return;
  }
  int e0, e1;
  if (!rkc_stream_chunk(s, chunk, e0, e1)) return;
  const int n = e1 - e0;                  // the pipeline's depth
  const bool last = e1 == s + 1;
  const int ext = grid.extent_rings(s + 1 - e1);
  const RkcStreamPlan plan = rkc_stream_plan(grid, nz, ext, min_tiles);
  if (t >= plan.tiles) return;
  const int in_plane = plan.ntx * plan.nty;
  const int tz = t / in_plane, ty = (t - tz * in_plane) / plan.ntx;
  const int tx = t - tz * in_plane - ty * plan.ntx;
  const int z0 = tz * plan.z_chunk;
  const int z1 = min(z0 + plan.z_chunk, nz);
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  const T hmu1 = h * mu1_tab[s];
  const T h04 = T(0.4) * h;
  const T* const row = ctab + static_cast<size_t>(s)
                                  * (kRkcTableStages + 1) * 4;
  // the hand-on values: F0, Y_e, Y_{e-1}, each u then v
  T* const wf0 = work;
  T* const wcur = work + 2 * var1;
  T* const wprev = work + 4 * var1;

  StreamSlots<T> sl;
  stream_slots<Mode>(c, fz, grid, ty * kStreamTileY - ext,
                     tx * kStreamTileX - ext, ext, goff, sl);
  // evaluation i runs at planes [lo[i], hi[i]); iteration p takes it at
  // plane p - i
  int lo[D], hi[D];
  stream_cone(n, z0, z1, nz, lo, hi);
  const int p_end = z1 + n - 1;

  // ring 0, the chunk's first input: y's variable 0, or Y_e's from the
  // chunk before, on the tile and n rings
  const T* const src0 = chunk == 0 ? y : wcur;
  T nu[S];
  stream_ring0_begin(src0, rings, sl, n, lo[0], nz, plane, nu);

  // the planes in flight, lag by lag (lag l: plane p - l, before
  // evaluation l): cv[l], pv[l] the v of its input Y_e and of Y_{e-1}
  T cv[D][S], pv[D][S];
  T acc = T(0);
  for (int p = lo[0]; p < p_end; ++p) {
    stream_ring0_store(rings, sl, n, p, nz, nu);
    stream_ring0_load(src0, sl, n, p, nz, plane, nu);
    // the pointwise inputs of plane p, evaluation 0's: y0's v, or the
    // chunk before's Y_e's v, Y_{e-1} (pu0: its u) and F0
    T pu0[SE];
    {
      const Off k0 = min(p, nz - 1) * plane;
#pragma unroll
      for (int m = 0; m < SE; ++m) {
        if (!sl.within(m, n - 1)) continue;
        const Off g = k0 + sl.go[m];
        if (chunk == 0) {
          cv[0][m] = y[var1 + g];
          continue;
        }
        cv[0][m] = wcur[var1 + g];
        pv[0][m] = wprev[var1 + g];
        pu0[m] = wprev[g];
        T* const f = f0s + (p % D) * 2 * NP + threadIdx.x
                     + kStreamThreads * m;
        f[0] = wf0[g];
        f[NP] = wf0[var1 + g];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i >= n) break;                  // the same for every thread
      if (i > 0) __syncthreads();         // ring i holds Y_{e0+i}(p - i + 1)
      const int q = p - i;
      if (q < lo[i] || q >= hi[i]) continue;
      const int e = e0 + i;
      const int kU = min(q + 1, nz - 1), kD = max(q - 1, 0);
      const T* const in = rings + i * 3 * L;
      const T* const um = in + (q % 3) * L;
      const T* const uu = in + (kU % 3) * L;
      const T* const ud = in + (kD % 3) * L;
      // Y_{e-1}'s u at plane q: ring i - 1 (evaluation 1 of the first
      // chunk: Y_0 = y0's)
      const T* const pin = rings + (i > 0 ? i - 1 : 0) * 3 * L + (q % 3) * L;
      const bool own = q >= z0 && q < z1;  // a plane of the block's chunk
      // the recurrence's coefficients of Y_{e+1}, 1 <= e < s
      const int j = e + 1;
      T cy0 = T(0), mu = T(0), nuc = T(0), hmut = T(0), hgt = T(0);
      if (e > 0 && e < s) {
        mu = row[4 * j];
        nuc = row[4 * j + 1];
        cy0 = T(1) - mu - nuc;
        hmut = h * row[4 * j + 2];
        hgt = h * row[4 * j + 3];
      }
#pragma unroll
      for (int m = 0; m < SE; ++m) {
        // evaluation i on the tile and n - 1 - i rings
        if (m >= ST && !sl.within(m, n - 1 - i)) continue;
        const int li = sl.local(m);
        const Off g = q * plane + sl.go[m];
        T du, dv, gu, gv;
        stream_forcing(stim, box_rkc_column(stim, e), q, sl.rc[m], gu, gv);
        stream_rhs<Mode, Kin, W, Stim::kOn>(
            c, sl.template point<Mode>(c, fz, m), ud, um, uu, goff, li, q,
            kD, kU, plane, cv[i][m], gu, gv, du, dv);
        const T cu = um[li], cvm = cv[i][m];
        T* const f = f0s + (q % D) * 2 * NP + threadIdx.x
                     + kStreamThreads * m;
        T yu, yv;                         // Y_{e+1}
        if (e == 0) {
          // F0 and Y1 = y0 + (h mu1) F0; F0 to the next chunk
          f[0] = du;
          f[NP] = dv;
          if (!last && m < ST && own && sl.write[m]) {
            wf0[g] = du;
            wf0[var1 + g] = dv;
          }
          yu = cu + hmu1 * du;
          yv = cvm + hmu1 * dv;
        } else {
          const T fu = f[0], fv = f[NP];
          const T u0 = y[g], v0 = y[var1 + g];
          if (e == s) {
            // F1 = f(Y_s): y_new and the error on the tile; the WRMS
            // weights from the step's start
            if (m >= ST) continue;
            if (sl.write[m]) {
              y_new[g] = cu;
              y_new[var1 + g] = cvm;
            }
            if (sl.count[m]) {
              const T eu = T(0.8) * (u0 - cu) + h04 * (fu + du);
              const T ev = T(0.8) * (v0 - cvm) + h04 * (fv + dv);
              const T wu = eu * (T(1) / (rtol * fabs(u0) + atol));
              const T wv = ev * (T(1) / (rtol * fabs(v0) + atol));
              acc = acc + wu * wu;
              acc = acc + wv * wv;
            }
            continue;
          }
          const T pu = i > 0 ? pin[li] : pu0[m];
          yu = cy0 * u0 + mu * cu + nuc * pu + hmut * du + hgt * fu;
          yv = cy0 * v0 + mu * cvm + nuc * pv[i][m] + hmut * dv + hgt * fv;
        }
        if (i < n - 1) {
          rings[((i + 1) * 3 + q % 3) * L + li] = yu;
        } else if (m < ST && own && sl.write[m]) {
          // the chunk's last stage values, to the next chunk
          wcur[g] = yu;
          wcur[var1 + g] = yv;
          wprev[g] = cu;
          wprev[var1 + g] = cvm;
        }
        pv[i][m] = cvm;
        cv[i][m] = yv;
      }
    }
    // the planes in flight move up one lag
#pragma unroll
    for (int l = D - 1; l > 0; --l) {
#pragma unroll
      for (int m = 0; m < S; ++m) {
        cv[l][m] = cv[l - 1][m];
        pv[l][m] = pv[l - 1][m];
      }
    }
  }
  if (last) store_block_sum<T, kStreamThreads>(acc, warp_sums, ss);
}

// Launch the chunks of one step in a mode the scheme takes on `stream`:
// ceil((s_cap + 1) / kStreamDepth) launches of the largest tile count any
// s gives the chunk; the partial sums are the last chunk's tiles (at most
// `capacity`, their count to *n_blocks); the forcing `stim` (NoStim: none).
// Returns the CUDA error code, checked after each launch.
template <typename T, class Grid, class Stim>
int launch_box_rkc_stream(const BoxConstants<T>& c, Grid grid, int mode,
                          int kinetics, const void* y, void* y_new, void* ss,
                          int capacity, int* n_blocks, void* work,
                          const void* h, const void* fz, const void* s,
                          const void* mu1_tab, const void* ctab, int s_cap,
                          int min_tiles, double rtol, double atol,
                          void* stream, const Stim& stim) {
  // offsets into the state and `work` in an int, rows and columns in 16
  // bits each
  if (!rkc_stream_take(mode) || !valid_kinetics(kinetics) || s_cap < 2
      || s_cap > kRkcStreamStages || min_tiles < 1
      || 6LL * c.nz * c.ny * c.nx >= (1LL << 31) || c.ny > 0xffff
      || c.nx > 0xffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const RkcStreamPlan sums = rkc_stream_plan(grid, c.nz, 0, min_tiles);
  if (sums.tiles > capacity) return static_cast<int>(cudaErrorInvalidValue);
  *n_blocks = sums.tiles;
  const int chunks = (s_cap + kStreamDepth) / kStreamDepth;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    // the most tiles the chunk has at any s (chunk 0 also keeps y when s
    // is out of range, on the last chunk's tiles)
    int blocks = chunk == 0 ? sums.tiles : 0;
    for (int st = 2; st <= s_cap; ++st) {
      int e0, e1;
      if (!rkc_stream_chunk(st, chunk, e0, e1)) continue;
      const int t = rkc_stream_plan(grid, c.nz,
                                    grid.extent_rings(st + 1 - e1),
                                    min_tiles).tiles;
      if (t > blocks) blocks = t;
    }
    const auto launch = [&](auto m, auto k) {
      auto kernel =
          &fused_box_rkc_stream_kernel<decltype(m)::value, decltype(k)::value,
                                       Grid, T, Stim>;
      const size_t smem = rkc_stream_bytes(sizeof(T));
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<blocks, kStreamThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(y), static_cast<T*>(y_new),
          static_cast<T*>(ss), static_cast<T*>(work),
          static_cast<const T*>(h), static_cast<const T*>(fz),
          static_cast<const int*>(s), static_cast<const T*>(mu1_tab),
          static_cast<const T*>(ctab), s_cap, c, grid, chunk, min_tiles,
          static_cast<T>(rtol), static_cast<T>(atol), stim);
      return static_cast<int>(cudaGetLastError());
    };
    const int rc = dispatch_kinetics<kBoxTensor>(kinetics, launch);
    if (rc != 0) return rc;
  }
  return 0;
}

// stream_info of the unforced kernel of (mode, kinetics) on the grid
// policy Grid (a mode the scheme takes).
template <typename T, class Grid>
int rkc_stream_kernel_info(int mode, int kinetics, int* out) {
  if (!rkc_stream_take(mode) || !valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto info = [&](auto m, auto k) {
    return stream_info(
        &fused_box_rkc_stream_kernel<decltype(m)::value, decltype(k)::value,
                                     Grid, T, NoStim>,
        rkc_stream_bytes(sizeof(T)), out);
  };
  return dispatch_kinetics<kBoxTensor>(kinetics, info);
}

}  // namespace crd
