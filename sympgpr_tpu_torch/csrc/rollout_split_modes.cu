// The rollout kernel's library of the Split instances of the wrap,
// explicit and sum modes (the kernel, its design and its interface:
// rollout_kernel.cuh): Split cycling or one map checked at the new q,
// together with the mod_p wrap and pdiff (implicit map, each GP and aux
// kind), the explicit product update (each GP kind) or Algorithm 2 (kind
// 3).  7 instances a shape (ops/cuda_step.py::INSTANCES), 42 in all.  A
// library of its own, so its nvcc runs beside rollout_step.cu's and the
// one-map instances keep their code.
//
//   rollout_split_modes_f32, rollout_split_modes_f64: the C interface
//   (ROLLOUT_ENTRY).

#include "rollout_kernel.cuh"

ROLLOUT_ENTRY(rollout_split_modes_f32, true, float)
ROLLOUT_ENTRY(rollout_split_modes_f64, true, double)
