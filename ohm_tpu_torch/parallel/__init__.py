"""Spatial sharding of the occupancy map over a ShardMesh (single process).

Counterpart of ``ohm_tpu/parallel/``: each shard owns the regions whose
super-region hashes to it (``region_owner``), keeps them in its own arena on
its mesh device, and runs the port's unchanged single-device cores on the
records that land in them, so no two shards write one voxel.  Ray batches
are replicated (``sharded``), routed on the host (``sharded``, ``mapper``)
or routed on the devices (``a2a``, and ``rayflow`` on the rayflow wire).
``dryrun`` drives every scheme against the single-device mappers.
"""

from ohm_tpu_torch.parallel.a2a import make_source_batch, sharded_integrate_a2a
from ohm_tpu_torch.parallel.dryrun import dryrun_multichip
from ohm_tpu_torch.parallel.mapper import ResidentShardedArena, ShardedRayMapper
from ohm_tpu_torch.parallel.mesh import ShardMesh
from ohm_tpu_torch.parallel.rayflow import ShardedRayFlowMapper
from ohm_tpu_torch.parallel.sharded import (ShardedArena, check_routed_coverage,
                                            check_sharded_coverage, make_routed_batch,
                                            make_sharded_batch, region_owner,
                                            region_owner_torch, sharded_integrate,
                                            sharded_integrate_routed)

__all__ = ["ResidentShardedArena", "ShardMesh", "ShardedArena", "ShardedRayFlowMapper",
           "ShardedRayMapper", "check_routed_coverage", "check_sharded_coverage",
           "dryrun_multichip", "make_routed_batch", "make_sharded_batch", "make_source_batch",
           "region_owner", "region_owner_torch", "sharded_integrate", "sharded_integrate_a2a",
           "sharded_integrate_routed"]
