// The forced instantiations of kernel K7 (fused_box3d_rkc.cu): its launch
// with a structured forcing (rhs_common.cuh::BoxStimTable) in both
// schemes, f32 and f64, compiled in a unit of their own beside the
// unforced ones (ops/_build.py compiles the sources in parallel).

#define CRD_BOX_FORCED_UNIT
#include "fused_box3d_rkc.cu"

namespace crd_k7 {

int launch_forced(CRD_FUSED_BOX3D_RKC_ARGS,
                  const crd::BoxStimTable<float>& stim) {
  return launch_stim<float>(CRD_FUSED_BOX3D_RKC_PASS, stim);
}

int launch_forced(CRD_FUSED_BOX3D_RKC_ARGS,
                  const crd::BoxStimTable<double>& stim) {
  return launch_stim<double>(CRD_FUSED_BOX3D_RKC_PASS, stim);
}

}  // namespace crd_k7
