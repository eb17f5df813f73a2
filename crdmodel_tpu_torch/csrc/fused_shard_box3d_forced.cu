// The forced instantiations of kernel K12 (fused_shard_box3d.cu): its
// launch with a structured forcing (rhs_common.cuh::BoxStimTable) in both
// schemes, f32 and f64, compiled in a unit of their own beside the
// unforced ones (ops/_build.py compiles the sources in parallel).

#define CRD_BOX_FORCED_UNIT
#include "fused_shard_box3d.cu"

namespace crd_k12 {

int launch_forced(CRD_FUSED_SHARD_BOX3D_ARGS,
                  const crd::BoxStimTable<float>& stim) {
  return launch_stim<float>(CRD_FUSED_SHARD_BOX3D_PASS, stim);
}

int launch_forced(CRD_FUSED_SHARD_BOX3D_ARGS,
                  const crd::BoxStimTable<double>& stim) {
  return launch_stim<double>(CRD_FUSED_SHARD_BOX3D_PASS, stim);
}

}  // namespace crd_k12
