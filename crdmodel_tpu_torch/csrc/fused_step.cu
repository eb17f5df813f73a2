// Fused embedded-ERK step of the 5-point profile operator with
// FitzHugh-Nagumo or Goldbeter kinetics (kernel K1 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_step.py::build_fused_step, the Pallas TPU
// kernel that takes every attempted step of the canonical FHN and Goldbeter
// torus runs with their own method, bs32.
// One launch performs a whole step: every stage's stencil and kinetics, the
// solution update, and one partial sum of squared WRMS-scaled errors per
// thread block. The caller sums the partials (no float atomics, so two
// launches on the same input give bitwise-equal results).
//
// What bounds it on an H100: the state (2 x ny x nx) is read once and
// y_new written once (about 10 MB a bs32 step on 400x1600 in f32), and the
// stage arithmetic is a few dozen flops a point. Neither bandwidth nor
// flops is near its limit; a step is bound by latency: the block's
// barriers between stages, the shared-memory traffic of the stage
// buffers, and the host's launches around the kernel.
//
// Design: each thread block owns a tile of tile_y x tile_x points and loads
// it with a halo of n_stages rings (the periodic wrap is a modular index at
// load). Stage s is evaluated from shared memory on a region that shrinks by
// one ring per stage, so the last stage is valid on the tile and no stage
// value ever goes to device memory. All stages are evaluated (no FSAL). The
// arithmetic follows the plain version (ops/fused_step.py::
// fused_step_reference) operation for operation, and the library is built
// with -fmad=false so that no multiply and add are contracted: each
// operation rounds as PyTorch's does. The RHS at a point is the shared
// device function of rhs_common.cuh, with the kinetics family a template
// parameter (one instance per family). No tensor cores, TMA or tuning yet.

#include <cuda_runtime.h>

#include "rhs_common.cuh"

namespace {

using crd::wrap;

constexpr int kMaxStages = 8;
constexpr int kThreads = 256;

struct StageTable {
  int n;
  double a[kMaxStages][kMaxStages];
  double b[kMaxStages];
  double d[kMaxStages];   // b - bhat
};

template <int Kin, typename T>
__global__ void __launch_bounds__(kThreads) fused_erk_step_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    crd::RhsConstants<T> k, int ny, int nx, int tile_x, int tile_y,
    StageTable tab, T rtol, T atol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kThreads / 32];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int halo = tab.n;
  const int W = tile_x + 2 * halo;    // region width (x, contiguous)
  const int R = tile_y + 2 * halo;    // region rows
  const int np = W * R;
  T* y0u = smem;                      // the step's start, both variables
  T* y0v = y0u + np;
  T* yiu = y0v + np;                  // the current stage input
  T* yiv = yiu + np;
  T* ks = yiv + np;                   // stage s: u at ks + 2s*np, v after
  const int gx0 = blockIdx.x * tile_x - halo;
  const int gy0 = blockIdx.y * tile_y - halo;
  const size_t plane = static_cast<size_t>(ny) * nx;

  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int ly = p / W, lx = p - ly * W;
    const size_t g = static_cast<size_t>(wrap(gy0 + ly, ny)) * nx
                     + wrap(gx0 + lx, nx);
    y0u[p] = y[g];
    y0v[p] = y[plane + g];
  }
  const T h = *h_ptr;
  const T fz = k.has_freeze ? *fz_ptr : T(0);
  __syncthreads();

  for (int s = 0; s < tab.n; ++s) {
    const T* su = y0u;
    const T* sv = y0v;
    if (s > 0) {
      // yi = y0 + (h a[s][0]) k_0 + ... on the points at depth >= s
      const int w = W - 2 * s, r = R - 2 * s;
      for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
        const int p = (s + q / w) * W + s + q % w;
        T u = y0u[p], v = y0v[p];
        for (int j = 0; j < s; ++j) {
          if (tab.a[s][j] != 0.0) {
            const T ha = h * static_cast<T>(tab.a[s][j]);
            u = u + ha * ks[(2 * j) * np + p];
            v = v + ha * ks[(2 * j + 1) * np + p];
          }
        }
        yiu[p] = u;
        yiv[p] = v;
      }
      __syncthreads();
      su = yiu;
      sv = yiv;
    }
    // k_s = rhs(yi) on the points at depth >= s + 1
    T* ku = ks + (2 * s) * np;
    T* kv = ku + np;
    const int dep = s + 1;
    const int w = W - 2 * dep, r = R - 2 * dep;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = dep + q / w, lx = dep + q % w;
      const int p = ly * W + lx;
      const int gy = wrap(gy0 + ly, ny), gx = wrap(gx0 + lx, nx);
      crd::profile_rhs<Kin>(k, fz, su, sv, p, W, gy, gx, ku[p], kv[p]);
    }
    __syncthreads();
  }

  // y_new and the error on the tile; WRMS weights from the step's start
  T acc = T(0);
  for (int q = threadIdx.x; q < tile_x * tile_y; q += blockDim.x) {
    const int ty = q / tile_x, tx = q - ty * tile_x;
    const int gy = blockIdx.y * tile_y + ty, gx = blockIdx.x * tile_x + tx;
    if (gy >= ny || gx >= nx) continue;
    const int p = (ty + halo) * W + tx + halo;
    const T u0 = y0u[p], v0 = y0v[p];
    T nu = u0, nv = v0, eu = T(0), ev = T(0);
    for (int s = 0; s < tab.n; ++s) {
      const T* ku = ks + (2 * s) * np;
      if (tab.b[s] != 0.0) {
        const T hb = h * static_cast<T>(tab.b[s]);
        nu = nu + hb * ku[p];
        nv = nv + hb * ku[np + p];
      }
      if (tab.d[s] != 0.0) {
        const T hd = h * static_cast<T>(tab.d[s]);
        eu = eu + hd * ku[p];
        ev = ev + hd * ku[np + p];
      }
    }
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    y_new[g] = nu;
    y_new[plane + g] = nv;
    const T wu = eu * (T(1) / (rtol * fabs(u0) + atol));
    const T wv = ev * (T(1) / (rtol * fabs(v0) + atol));
    acc = acc + wu * wu;
    acc = acc + wv * wv;
  }

  crd::store_block_sum<T, kThreads>(acc, warp_sums, ss);
}

template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* c0, const void* c1, const void* c2,
           int torus, const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int ny, int nx, int tile_x,
           int tile_y, int n_stages, const double* a, const double* b,
           const double* d, double rtol, double atol, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || ny < 1 || nx < 1
      || tile_x < 1 || tile_y < 1
      || (kinetics != crd::kFhn && kinetics != crd::kGoldbeter))
    return static_cast<int>(cudaErrorInvalidValue);
  StageTable tab = {};
  tab.n = n_stages;
  for (int s = 0; s < n_stages; ++s) {
    for (int j = 0; j < n_stages; ++j) tab.a[s][j] = a[s * n_stages + j];
    tab.b[s] = b[s];
    tab.d[s] = d[s];
  }
  const size_t smem = static_cast<size_t>(2 * n_stages + 4)
                      * (tile_x + 2 * n_stages) * (tile_y + 2 * n_stages)
                      * sizeof(T);
  auto kernel = kinetics == crd::kFhn
                    ? &fused_erk_step_kernel<crd::kFhn, T>
                    : &fused_erk_step_kernel<crd::kGoldbeter, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz), k, ny, nx,
      tile_x, tile_y, tab, static_cast<T>(rtol), static_cast<T>(atol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define CRD_FUSED_STEP_ARGS                                                  \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,      \
      const void *c0, const void *c1, const void *c2, int torus,            \
      const void *beta, int beta_field, const void *mask, int has_freeze,   \
      int kinetics, int ny, int nx, int tile_x, int tile_y, int n_stages,   \
      const double *a, const double *b, const double *d, double rtol,       \
      double atol, void *stream
#define CRD_FUSED_STEP_PASS                                                  \
  y, y_new, ss, h, fz, c0, c1, c2, torus, beta, beta_field, mask,           \
      has_freeze, kinetics, ny, nx, tile_x, tile_y, n_stages, a, b, d,      \
      rtol, atol, stream

extern "C" int crd_fused_erk_step_f32(CRD_FUSED_STEP_ARGS) {
  return launch<float>(CRD_FUSED_STEP_PASS);
}

extern "C" int crd_fused_erk_step_f64(CRD_FUSED_STEP_ARGS) {
  return launch<double>(CRD_FUSED_STEP_PASS);
}
