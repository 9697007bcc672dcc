"""ohm_tpu_torch — the occupancy mapping engine on PyTorch and CUDA.

The PyTorch port of ``ohm_tpu``, which stays beside it as the reference.
This package imports ``torch`` and never ``jax``, and nothing of ``ohm_tpu``:
it keeps its own copies of the host modules it needs, under the same
sub-package names (numpy, not ported).

Layer map (each module names its ``ohm_tpu`` counterpart):
  app/               ohmpop, the other CLIs, the harness (ohm_tpu/app; harness.build_mapper
                     builds this package's mappers: --device cuda | cpu | oracle)
  io/                .ohm, PLY, PCD, LAS/LAZ, SLAM clouds (ohm_tpu/io, copies but
                     slam.transform_samples_device, in PyTorch)
  heightmap/         2.5D heightmaps                   (ohm_tpu/heightmap, copies)
  tools/, utils/     map generators; log, progress, profile, trace (copies)
  core/              host map, layout, keys, filters   (ohm_tpu/core, copies)
  oracle/            f64 ground truth, secondary samples (ohm_tpu/oracle, copies)
  native/            rayflow host pass, LASzip codec in C++ (ohm_tpu/native, copies)
  device.py          explicit device choice; no silent fall back to the CPU
  mapping/batch.py   rayflow host wire              (ohm_tpu/mapping/batch.py)
  mapping/arena.py   device voxel arena             (ohm_tpu/mapping/arena.py)
  mapping/torch_map  TorchRayMapper                 (ohm_tpu/mapping/tpu_map.py)
  mapping/ndt_map    TorchNdtMap, NDT-OM/TM         (ohm_tpu/mapping/ndt_map.py)
  mapping/tsdf_map   TorchTsdfMap, TSDF             (ohm_tpu/mapping/tsdf_map.py)
  ops/wire.py        rayflow wire decode            (ohm_tpu/ops/integrate.py)
  ops/ddawalk.py     rank walk, K1's plain version  (ohm_tpu/ops/ddawalk.py)
  ops/integrate.py   expand and apply phases        (ohm_tpu/ops/integrate.py)
  ops/integrate_ndt  NDT miss, hit and deposit      (ohm_tpu/ops/integrate_ndt.py)
  ops/integrate_tsdf TSDF per-visit and per-batch    (ohm_tpu/ops/integrate_tsdf.py)
  ops/ndt.py         NDT math                       (ohm_tpu/ops/ndt.py)
  ops/subvoxel.py    sub-voxel mean codec           (ohm_tpu/ops/subvoxel_jnp.py)
  ops/segments.py    deterministic segment sums     (ohm_tpu/ops/integrate.py, blocked.py)
  ops/expand_cuda    K1 wrapper  -> csrc/expand.cu  (ohm_tpu/ops/expand_pallas.py)
  ops/deposit_cuda   K2, K3, K6  -> csrc/deposit.cu (ohm_tpu/ops/deposit_pallas.py)
  ops/gather_cuda    K4, K5      -> csrc/gather.cu  (ohm_tpu/ops/deposit_pallas.py)
  ops/probes_cuda    P-A probes  -> csrc/probes.cu  (scripts/probe_deposit.py)
  ops/slotgrid_cuda  P-B deposit -> csrc/slotgrid.cu (scripts/probe_deposit.py)
  scripts/probe_deposit  the deposit probe's entry point (scripts/probe_deposit.py)
  parallel/          spatial sharding over a ShardMesh, one process driving a
                     device a shard: ShardedRayMapper, ShardedRayFlowMapper, a2a
                     routing, dryrun_multichip (ohm_tpu/parallel, __graft_entry__.py)
"""

__version__ = "0.1.0"

from ohm_tpu_torch.core.probability import probability_to_value, value_to_probability
from ohm_tpu_torch.core.map import OccupancyMap, MapFlag
from ohm_tpu_torch.core.layout import MapLayout, MapLayer, VoxelLayout, DataType, default_layout
from ohm_tpu_torch.core.rayflags import RayFlag, RayFilterFlag
from ohm_tpu_torch.device import require_cuda, resolve_device
from ohm_tpu_torch.io import load, save
from ohm_tpu_torch.mapping.ndt_map import TorchNdtMap
from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
from ohm_tpu_torch.mapping.tsdf_map import TorchTsdfMap

__all__ = ["DataType", "MapFlag", "MapLayer", "MapLayout", "OccupancyMap", "RayFilterFlag",
           "RayFlag", "TorchNdtMap", "TorchRayMapper", "TorchTsdfMap", "VoxelLayout",
           "default_layout", "load", "probability_to_value", "require_cuda", "resolve_device",
           "save", "value_to_probability"]
