"""Distributed training and inference across processes, one a card
(resuneta_tpu/parallel): the data and space axes of the step's reductions,
halos and gathers (axis.py), the groups and their batch sharding (mesh.py:
the data-parallel DataGroup; the 2-D SpaceMesh of make_mesh_2d, which also
shards the image height, with halo exchanges), the processes
(multihost.py) and their start on one host (launch.py)."""
from . import axis, multihost
from .mesh import (DataGroup, SpaceMesh, destroy_group, init_group,
                   make_mesh_2d, replicate_state, shard_batch,
                   shard_batch_spatial, spatial_batch_sharding)

__all__ = ["DataGroup", "SpaceMesh", "axis", "destroy_group", "init_group",
           "make_mesh_2d", "multihost", "replicate_state",
           "shard_batch", "shard_batch_spatial", "spatial_batch_sharding"]
