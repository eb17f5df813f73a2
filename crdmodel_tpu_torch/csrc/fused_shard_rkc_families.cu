// Kernel K9 (fused_shard_rkc.cu) for the six kinetics families beyond the
// base three: Barkley, the Oregonator, Gray-Scott, the Brusselator,
// lambda-omega and SIR (ops/kernel_common.py::NEW_FAMILIES), unforced, on
// the 5-point profile operator, one shard's block in the halo the exchange
// filled. Compiled apart from fused_shard_rkc.cu, so that the build
// compiles these instantiations beside the others.
//
// Replaces the same TPU kernel as fused_shard_rkc.cu
// (crdmodel_tpu/ops/pallas_shard_rkc.py::build_fused_shard_rkc), whose
// tile body traces any family (pallas kernel_common.py:110-159).
//
// Design: K2's family kernel (fused_rkc_families.cu) with the HaloGrid
// policy (rkc_chunk.cuh::fused_rkc_chunk_n_kernel<Kin, HaloGrid, T>): the
// s + 1 RHS evaluations in chunks of at most 6, a grid barrier between
// them; the exchange's P_RKC = 24 >= s + 1 rings hold the block's cone of
// dependence for the step, so chunk c's tiles cover the block grown by the
// evaluations still to come (ChunkOrigin<HaloGrid>) and the chunks exchange
// nothing; every variable of y0 and F0 in shared memory, every variable of
// Yj-1 and Yj-2 in the registers of the point's thread, two shared planes
// of Yj-1 for each diffusing variable; `work` holds F0 and two (Yj-1,
// Yj-2) sets in turns, 5 planes of the buffer a variable. The partial sums
// are K9's sum tiles (ops/fused_shard_rkc.py::sum_tiles), each in the
// one-pass kernels' order, variable by variable, a mirror-pad cell adding
// +0.0: y_new's block and every partial sum are bitwise the plain
// version's (ops/fused_shard_rkc.py::fused_shard_rkc_step_reference,
// fused_shard_rkc_tile_sums).

#include <cuda_runtime.h>

#include "rhs_common.cuh"
#include "rkc_chunk.cuh"

namespace {

template <typename T>
int launch(const void* y, void* y_new, void* ss, void* work, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* s, const void* mu1_tab, const void* ctab, int s_cap,
           const void* c0, const void* c1, const void* c2, int torus,
           const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int nyl, int nxl, int halo,
           int valid_rows, int valid_cols, int sum_tx, int sum_ty,
           double rtol, double atol, void* stream) {
  // unforced
  if (n_stim != 0 || amps != nullptr || rows != nullptr || cols != nullptr
      || s_cap < 2 || s_cap > crd::kRkcMaxStages || halo < s_cap + 1
      || nyl < 1 || nxl < 1 || sum_tx < 1 || sum_ty < 1 || valid_rows < 0
      || valid_rows > nyl || valid_cols < 0 || valid_cols > nxl)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)n_cols;
  (void)var1;
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const crd::HaloGrid grid = {nyl, nxl, halo, valid_rows, valid_cols};
  const int sums_x = (nxl + sum_tx - 1) / sum_tx;
  const crd::RkcPlan plan = {nyl,    nxl,    sum_tx,
                             sum_ty, sums_x, sums_x * ((nyl + sum_ty - 1)
                                                       / sum_ty)};
  const int most = crd::halo_max_tiles(s_cap, nyl, nxl);
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    constexpr int Kin = decltype(kin)::value;
    return crd::launch_rkc_chunk_n<Kin, crd::HaloGrid, T>(
        crd::FamilyRhs<Kin, T>{k}, grid, plan, most, y, y_new, ss, work, h,
        fz, s, mu1_tab, ctab, s_cap, rtol, atol, stream);
  });
}

template <typename T>
int info(int kinetics, int* out) {
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    return crd::rkc_chunk_n_info<decltype(kin)::value, crd::HaloGrid, T>(
        out);
  });
}

}  // namespace

#define CRD_FUSED_SHARD_RKC_ARGS                                             \
  const void *y, void *y_new, void *ss, void *work, const void *h,           \
      const void *fz, const void *amps, const void *rows,                    \
      const void *cols, int n_stim, int n_cols, int var1, const void *s,     \
      const void *mu1_tab, const void *ctab, int s_cap, const void *c0,      \
      const void *c1, const void *c2, int torus, const void *beta,           \
      int beta_field, const void *mask, int has_freeze, int kinetics,        \
      int nyl, int nxl, int halo, int valid_rows, int valid_cols,            \
      int sum_tx, int sum_ty, double rtol, double atol, void *stream
#define CRD_FUSED_SHARD_RKC_PASS                                             \
  y, y_new, ss, work, h, fz, amps, rows, cols, n_stim, n_cols, var1, s,      \
      mu1_tab, ctab, s_cap, c0, c1, c2, torus, beta, beta_field, mask,       \
      has_freeze, kinetics, nyl, nxl, halo, valid_rows, valid_cols, sum_tx,  \
      sum_ty, rtol, atol, stream

// crd_fused_shard_rkc_step's arguments (fused_shard_rkc.cu); the forcing's
// must be null and 0, and `work` holds 5 planes of the buffer a variable
extern "C" int crd_fused_shard_rkc_step_families_f32(
    CRD_FUSED_SHARD_RKC_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_RKC_PASS);
}

extern "C" int crd_fused_shard_rkc_step_families_f64(
    CRD_FUSED_SHARD_RKC_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_RKC_PASS);
}

// out[3] of a family's kernel (crd_fused_shard_rkc_info's)
extern "C" int crd_fused_shard_rkc_families_info(int f64, int kinetics,
                                                 int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
