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
// stages
// (integrate/rkc.py): F0 = f(y0), Y1 = y0 + (h mu1) F0, for j = 2..s
//   Yj = (1 - mu - nu) y0 + mu Yj-1 + nu Yj-2 + (h mut) f(Yj-1) + (h gt) F0,
// y_new = Ys, F1 = f(y_new), the order-2 error estimate
// est = 0.8 (y0 - y_new) + (0.4 h)(F0 + F1), and one partial sum of squared
// WRMS-scaled errors per thread block (summed by the caller; no float
// atomics, so two launches on the same input give bitwise-equal results).
//
// The stage count s, h, the freeze scalar and the coefficient tables live
// on the device: the kernel reads s and indexes mu1[s] and ctab[s][j]
// itself, so the host never learns s. An s outside [2, s_cap] is refused
// by NaN partial sums, which the adaptive loop rejects.
//
// What bounds it on an H100: the state (2 x ny x nx) is read once and
// y_new written once (about 10 MB a step on 400x1600 in f32, 655 MB on
// 12800x3200), whatever s; the divergence form adds its face fields (aE,
// aW, aN, the tissue field: 10.2 MB at 1600x400 in f32).
// The work is s + 2 right-hand sides a point, on a region that carries a
// halo of s + 1 rings: at s = 23 a 32x32 tile computes about 3.1x its own
// points on average over the evaluations, at s = 5 about 1.35x. The block's
// barriers between stages and the shared-memory traffic bound a step long
// before device memory does.
//
// Design: each block owns a tile_y x tile_x tile and loads it with a halo
// of s + 1 rings by modular index (the periodic wrap, any number of times
// on grids smaller than the halo). The three-term recurrence has a live set
// of constant size, kept in shared memory: y0, F0, Yj-1 and Yj-2, two
// variables each. Yj overwrites Yj-2 in place (it reads Yj-2 only at its
// own point), so four buffers carry any s. Stage j is evaluated on the
// points at depth >= j, and F1 on the tile. Shared memory is sized for
// s_cap + 1 rings when the launch is configured, before s is known; a
// smaller s packs its smaller region into the same space. The arithmetic
// follows the plain version (ops/fused_rkc.py::fused_rkc_step_reference)
// operation for operation, and the library is built with -fmad=false. The
// right-hand side at a point is a functor the kernel template takes, as in
// erk_tile.cuh: ProfileRhs, or DivformRhs (K4's operator, whose face
// coefficients are read through the read-only data cache, no new shared
// arrays), each over the kinetics family. No tensor cores, TMA or tuning
// yet.

#include <cuda_runtime.h>

#include "rhs_common.cuh"

namespace {

using crd::wrap;

constexpr int kMaxStages = 23;    // ops/fused_rkc.py S_MAX_KERNEL
constexpr int kThreads = 512;

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// The functor: rhs(fz, su, sv, p, W, gy, gx, du, dv) writes ydot at local
// point p of a region with row stride W (erk_tile.cuh).
template <class Rhs, typename T>
__global__ void __launch_bounds__(kThreads) fused_rkc_step_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    const int* __restrict__ s_ptr, const T* __restrict__ mu1_tab,
    const T* __restrict__ ctab, int s_cap, Rhs rhs, int ny, int nx,
    int tile_x, int tile_y, T rtol, T atol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kThreads / 32];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int s = *s_ptr;
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  const size_t plane = static_cast<size_t>(ny) * nx;
  if (s < 2 || s > s_cap) {
    // no table row for this stage count: keep y, poison the error sum
    for (int q = threadIdx.x; q < tile_x * tile_y; q += blockDim.x) {
      const int ty = q / tile_x, tx = q - ty * tile_x;
      const int gy = blockIdx.y * tile_y + ty, gx = blockIdx.x * tile_x + tx;
      if (gy >= ny || gx >= nx) continue;
      const size_t g = static_cast<size_t>(gy) * nx + gx;
      y_new[g] = y[g];
      y_new[plane + g] = y[plane + g];
    }
    if (threadIdx.x == 0)
      ss[blockIdx.y * gridDim.x + blockIdx.x] = quiet_nan<T>();
    return;
  }

  const int halo = s + 1;
  const int W = tile_x + 2 * halo;    // region width (x, contiguous)
  const int R = tile_y + 2 * halo;    // region rows
  const int np = W * R;
  T* y0u = smem;                      // the step's start
  T* y0v = y0u + np;
  T* f0u = y0v + np;                  // F0 = f(y0)
  T* f0v = f0u + np;
  T* au = f0v + np;                   // Y1, then Yj in turns with b
  T* av = au + np;
  T* bu = av + np;
  T* bv = bu + np;
  const int gx0 = blockIdx.x * tile_x - halo;
  const int gy0 = blockIdx.y * tile_y - halo;

  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int ly = p / W, lx = p - ly * W;
    const size_t g = static_cast<size_t>(wrap(gy0 + ly, ny)) * nx
                     + wrap(gx0 + lx, nx);
    y0u[p] = y[g];
    y0v[p] = y[plane + g];
  }
  __syncthreads();

  // F0 and Y1 = y0 + (h mu1) F0 on the points at depth >= 1
  {
    const T hmu1 = h * mu1_tab[s];
    const int w = W - 2, r = R - 2;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = 1 + q / w, lx = 1 + q % w;
      const int p = ly * W + lx;
      T du, dv;
      rhs(fz, y0u, y0v, p, W, wrap(gy0 + ly, ny), wrap(gx0 + lx, nx), du,
          dv);
      f0u[p] = du;
      f0v[p] = dv;
      au[p] = y0u[p] + hmu1 * du;
      av[p] = y0v[p] + hmu1 * dv;
    }
  }
  __syncthreads();

  // stages j = 2..s on the points at depth >= j
  const T* pu = y0u;                  // Yj-2
  const T* pv = y0v;
  T* cu = au;                         // Yj-1
  T* cv = av;
  T* du_dst = bu;                     // Yj: b at j = 2, then Yj-2's buffer
  T* dv_dst = bv;
  const T* row = ctab + static_cast<size_t>(s) * (kMaxStages + 1) * 4;
  for (int j = 2; j <= s; ++j) {
    const T mu = row[4 * j], nu = row[4 * j + 1];
    const T mut = row[4 * j + 2], gt = row[4 * j + 3];
    const T cy0 = T(1) - mu - nu;
    const T hmut = h * mut, hgt = h * gt;
    const int w = W - 2 * j, r = R - 2 * j;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = j + q / w, lx = j + q % w;
      const int p = ly * W + lx;
      T fu, fv;
      rhs(fz, cu, cv, p, W, wrap(gy0 + ly, ny), wrap(gx0 + lx, nx), fu, fv);
      const T yju = cy0 * y0u[p] + mu * cu[p] + nu * pu[p] + hmut * fu
                    + hgt * f0u[p];
      const T yjv = cy0 * y0v[p] + mu * cv[p] + nu * pv[p] + hmut * fv
                    + hgt * f0v[p];
      du_dst[p] = yju;
      dv_dst[p] = yjv;
    }
    __syncthreads();
    pu = cu;
    pv = cv;
    T* old_u = cu;
    T* old_v = cv;
    cu = du_dst;
    cv = dv_dst;
    du_dst = old_u;
    dv_dst = old_v;
  }

  // F1 = f(y_new), y_new and the error on the tile (depth s + 1); WRMS
  // weights from the step's start
  const T h04 = T(0.4) * h;
  T acc = T(0);
  for (int q = threadIdx.x; q < tile_x * tile_y; q += blockDim.x) {
    const int ty = q / tile_x, tx = q - ty * tile_x;
    const int gy = blockIdx.y * tile_y + ty, gx = blockIdx.x * tile_x + tx;
    if (gy >= ny || gx >= nx) continue;
    const int p = (ty + halo) * W + tx + halo;
    T f1u, f1v;
    rhs(fz, cu, cv, p, W, gy, gx, f1u, f1v);
    const T yu = cu[p], yv = cv[p];
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    y_new[g] = yu;
    y_new[plane + g] = yv;
    const T eu = T(0.8) * (y0u[p] - yu) + h04 * (f0u[p] + f1u);
    const T ev = T(0.8) * (y0v[p] - yv) + h04 * (f0v[p] + f1v);
    const T wu = eu * (T(1) / (rtol * fabs(y0u[p]) + atol));
    const T wv = ev * (T(1) / (rtol * fabs(y0v[p]) + atol));
    acc = acc + wu * wu;
    acc = acc + wv * wv;
  }
  crd::store_block_sum<T, kThreads>(acc, warp_sums, ss);
}

// Launch one step of fused_rkc_step_kernel<Rhs, T> on `stream`; returns
// the CUDA error code (0 on success), checked right after the launch.
// Shared memory is sized for s_cap + 1 rings.
template <class Rhs, typename T>
int launch_kernel(Rhs rhs, const void* y, void* y_new, void* ss,
                  const void* h, const void* fz, const void* s,
                  const void* mu1_tab, const void* ctab, int s_cap, int ny,
                  int nx, int tile_x, int tile_y, double rtol, double atol,
                  void* stream) {
  const int halo = s_cap + 1;
  const size_t smem = static_cast<size_t>(8) * (tile_x + 2 * halo)
                      * (tile_y + 2 * halo) * sizeof(T);
  auto kernel = &fused_rkc_step_kernel<Rhs, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz),
      static_cast<const int*>(s), static_cast<const T*>(mu1_tab),
      static_cast<const T*>(ctab), s_cap, rhs, ny, nx, tile_x, tile_y,
      static_cast<T>(rtol), static_cast<T>(atol));
  return static_cast<int>(cudaGetLastError());
}

// The kernel for the kinetics id `kinetics`: DivformRhs when the face
// field aE is given, else ProfileRhs.
template <int Kin, typename T>
int launch_kinetics(const crd::RhsConstants<T>& k,
                    const crd::FaceConstants<T>& f, const void* y,
                    void* y_new, void* ss, const void* h, const void* fz,
                    const void* s, const void* mu1_tab, const void* ctab,
                    int s_cap, int ny, int nx, int tile_x, int tile_y,
                    double rtol, double atol, void* stream) {
  if (f.aE != nullptr)
    return launch_kernel<crd::DivformRhs<Kin, T>, T>(
        {f, k, ny, nx}, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, ny,
        nx, tile_x, tile_y, rtol, atol, stream);
  return launch_kernel<crd::ProfileRhs<Kin, T>, T>(
      {k}, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, ny, nx, tile_x,
      tile_y, rtol, atol, stream);
}

template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* s, const void* mu1_tab,
           const void* ctab, int s_cap, const void* c0, const void* c1,
           const void* c2, int torus, const void* ae, const void* aw,
           const void* an, const void* tissue, const void* beta,
           int beta_field, const void* mask, int has_freeze, int kinetics,
           int ny, int nx, int tile_x, int tile_y, double rtol, double atol,
           void* stream) {
  if (s_cap < 2 || s_cap > kMaxStages || ny < 1 || nx < 1 || tile_x < 1
      || tile_y < 1 || !crd::valid_kinetics(kinetics)
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
  if (kinetics == crd::kFhn)
    return launch_kinetics<crd::kFhn, T>(k, f, y, y_new, ss, h, fz, s,
                                         mu1_tab, ctab, s_cap, ny, nx,
                                         tile_x, tile_y, rtol, atol, stream);
  if (kinetics == crd::kGoldbeter)
    return launch_kinetics<crd::kGoldbeter, T>(
        k, f, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, ny, nx, tile_x,
        tile_y, rtol, atol, stream);
  return launch_kinetics<crd::kAlievPanfilov, T>(
      k, f, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, ny, nx, tile_x,
      tile_y, rtol, atol, stream);
}

}  // namespace

// c0, c1, c2 and torus: the profile operator (null without it); ae, aw, an
// and tissue: the divergence form's face fields and the 0/1 tissue field
// (all null without it; tissue null without an obstacle)
#define CRD_FUSED_RKC_ARGS                                                   \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,      \
      const void *s, const void *mu1_tab, const void *ctab, int s_cap,      \
      const void *c0, const void *c1, const void *c2, int torus,            \
      const void *ae, const void *aw, const void *an, const void *tissue,   \
      const void *beta, int beta_field, const void *mask, int has_freeze,   \
      int kinetics, int ny, int nx, int tile_x, int tile_y, double rtol,    \
      double atol, void *stream
#define CRD_FUSED_RKC_PASS                                                   \
  y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, c0, c1, c2, torus, ae, aw,  \
      an, tissue, beta, beta_field, mask, has_freeze, kinetics, ny, nx,     \
      tile_x, tile_y, rtol, atol, stream

extern "C" int crd_fused_rkc_step_f32(CRD_FUSED_RKC_ARGS) {
  return launch<float>(CRD_FUSED_RKC_PASS);
}

extern "C" int crd_fused_rkc_step_f64(CRD_FUSED_RKC_ARGS) {
  return launch<double>(CRD_FUSED_RKC_PASS);
}
