"""Ray mappers and the device voxel arena of the port (counterpart of
``ohm_tpu.mapping``)."""

from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
from ohm_tpu_torch.mapping.arena import VoxelArena

__all__ = ["TorchRayMapper", "VoxelArena"]
