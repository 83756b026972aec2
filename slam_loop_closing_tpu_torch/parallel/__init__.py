"""Scale-out over a ``torch.distributed`` process group, one device a rank.

Port of :mod:`slam_loop_closing_tpu.parallel`. The parallel axes of the
workload are the JAX package's:

* **DP over frames**: the feature front-end splits the frame batch.
* **Ring similarity**: the all-pairs loop-search counts pass descriptor
  blocks around the ring (``batch_isend_irecv``), each rank owning a block
  row of the [F, F] matrix.
* **DP over videos, candidate pairs, edges and observations**: multi-video
  detection, RANSAC verification, PGO and BA split their leading axis and
  all-reduce their partial sums.

:mod:`.mesh` makes the group (NCCL on CUDA; gloo only when the caller asks
for the CPU), :mod:`.launch` spawns ranks on one host, :mod:`.sharded` holds
the stages and :mod:`.dryrun` runs them all once at tiny shapes.
"""

from slam_loop_closing_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
