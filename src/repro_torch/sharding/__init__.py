"""The LM mesh paths' layout (counterpart of ``repro.sharding``).

``specs``        partition specs by parameter name, per mode, mesh and
                 config (``param_specs``, ``train_state_specs``,
                 ``decode_state_specs``)
``collectives``  the model code's collectives over ``torch.distributed``
                 (Megatron's copy / reduce pair, FSDP gathers, the data
                 mean, gradient sync), counted by kind
``params``       tensors and models split over a mesh and gathered back,
                 and their blocks' shapes alone (``empty_sharded``)
"""

from repro_torch.sharding.params import (
    empty_sharded,
    gather_params,
    gather_tensor,
    init_sharded,
    mesh_specs,
    shard_params,
    shard_tensor,
)
from repro_torch.sharding.specs import (
    decode_state_specs,
    fix_spec,
    param_shapes,
    param_specs,
    train_state_specs,
)
