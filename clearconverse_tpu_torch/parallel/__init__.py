"""The (data, model) device mesh over torch.distributed.

The port of the JAX package's parallel/ package. A mesh is ``data × model``
ranks of one process group: the data axis splits batch rows (segments are
independent), the model axis shards Whisper's heads and MLP Megatron-style
(``sharding``). Where the JAX package leaves the collectives to XLA, the
port writes them: Megatron's two around the sharded layers, and a gather of
results over the data axis. ``launch.run_group`` spawns ranks on one host;
``serve`` keeps serving single-controller (rank 0 runs the engine, the
other ranks follow its bundle calls).
"""

from clearconverse_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, build_mesh, init_process_group,
    local_device_count)
from clearconverse_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_spec, replicated_spec, shard_whisper, unshard_whisper,
    whisper_param_spec)
