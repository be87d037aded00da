"""Parallel execution of the port on `torch.distributed` (counterpart of
transparent_object_detection_tpu/parallel): one process a rank, data
parallelism over a `data` axis, Megatron tensor-parallel serving and
training over a `model` axis."""
from transparent_object_detection_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_multihost,
    process_count,
    process_index,
    shutdown_multihost,
)
from transparent_object_detection_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    local_batch_slice,
    make_mesh,
    replicate_state,
    shard_batch,
)
from transparent_object_detection_tpu_torch.parallel.tp import (  # noqa: F401
    MODEL_AXIS,
    gather_train_state_tp,
    make_2d_mesh,
    shard_params_tp,
    shard_train_state_tp,
    tp_shardings,
)
