// The rollout kernel's library of one-map instances and the Split implicit
// instance (the kernel, its design and its interface: rollout_kernel.cuh).
// Per dtype and instance shape (ops/cuda_step.py::INSTANCES: four float32,
// two float64): the implicit map for each GP and aux kind (periodic, se_se)
// without and with the mod_p wrap and pdiff, and Split (sub-map cycling or
// the loss check at the new q) without the wrap; the explicit update for
// each GP kind; Algorithm 2.  15 instances a shape, 90 in all.  Besides,
// the cluster instances (a cluster team; CLUSTER_INSTANCES, lanes of 4 or
// 8 points): the implicit one-map map without the wrap for each GP and aux
// kind, 4 a shape and dtype, 16 in all.
//
//   rollout_step_f32, rollout_step_f64: the C interface (ROLLOUT_ENTRY).

#include "rollout_kernel.cuh"

ROLLOUT_ENTRY(rollout_step_f32, false, float)
ROLLOUT_ENTRY(rollout_step_f64, false, double)
