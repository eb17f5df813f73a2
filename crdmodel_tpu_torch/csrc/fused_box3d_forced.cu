// The forced instantiations of kernel K6 (fused_box3d.cu): its launch with
// a structured forcing (rhs_common.cuh::BoxStimTable) in both schemes, f32
// and f64. They are compiled in a unit of their own, beside the unforced
// ones, so that the build's one-nvcc-per-source runs the two halves in
// parallel (ops/_build.py).

#define CRD_BOX_FORCED_UNIT
#include "fused_box3d.cu"

namespace crd_k6 {

int launch_forced(CRD_FUSED_BOX3D_ARGS,
                  const crd::BoxStimTable<float>& stim) {
  return launch_stim<float>(CRD_FUSED_BOX3D_PASS, stim);
}

int launch_forced(CRD_FUSED_BOX3D_ARGS,
                  const crd::BoxStimTable<double>& stim) {
  return launch_stim<double>(CRD_FUSED_BOX3D_PASS, stim);
}

}  // namespace crd_k6
