"""2.5D heightmap extraction (reference: ohmheightmap/).

TPU-first redesign: the reference walks 2D key space with planar / flood-fill
walkers and scans each column imperatively (ohmheightmap/Heightmap.cpp
buildHeightmapT); here the source map is assembled into a dense [X, Y, Z]
classification box and every column is reduced in parallel — surfaces,
virtual surfaces, clearance and multi-layer extraction all become vectorised
column reductions.
"""

from ohm_tpu_torch.heightmap.heightmap import (
    Heightmap,
    HeightmapMode,
    UpAxis,
    HeightmapVoxelType,
    HeightmapVoxelLayer,
    HVF_OBSERVED_ABOVE,
    add_heightmap_layer,
)
from ohm_tpu_torch.heightmap.mesh import HeightmapMesh
