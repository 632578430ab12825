"""Multi-device sharding of the step (counterpart of
``edyn_tpu/parallel``)."""
from .sharding import (  # noqa: F401
    BODY_AXIS, Mesh, ShardedState, gather_state, make_mesh,
    make_sharded_step, shard_state, state_shardings,
)
