"""Data-parallel training and inference across processes, one a card
(resuneta_tpu/parallel): the data axis of the step's reductions (axis.py),
the group and its batch sharding (mesh.py), the processes (multihost.py)
and their start on one host (launch.py). The JAX package's 'space' axis
(height sharding with halo exchanges) has no counterpart yet."""
from . import axis, multihost
from .mesh import (DataGroup, destroy_group, init_group, replicate_state,
                   shard_batch)

__all__ = ["DataGroup", "axis", "destroy_group", "init_group", "multihost",
           "replicate_state", "shard_batch"]
