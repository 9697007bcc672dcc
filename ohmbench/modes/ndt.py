"""ohmpop ``--mode ndt`` (NDT-OM): occupancy with ohm's NDT-OM miss
adjustment, and every sampled voxel's count, mean and covariance."""

from __future__ import annotations

from ohmbench.modes import occupancy

#: The occupancy numbers, the sampled voxels that disagree, and the NDT
#: misses the program turned into standard ones.
NUMBERS = occupancy.NUMBERS + ("ndt_mismatch_share", "ndt_overflow")
#: Occupancy, as in ``occupancy``: NDT-OM's miss and hit phases write it,
#: and the comparison reads it voxel by voxel.
VALUE_LAYERS = occupancy.VALUE_LAYERS


def make_reference(config: dict, geometry=None, values=None):
    from ohmbench.reference.ndt import NdtParams, NdtReference

    grid, params = occupancy.grid_and_params(config)
    ndt = NdtParams.from_config(config["ndt"], config["miss_probability"])
    return NdtReference(grid, params, ndt, *occupancy.precisions(config, geometry, values))


def program_map(m, config: dict, device) -> dict:
    from ohmbench.reference import compare

    return occupancy.read_layers(m, config, device, {
        "occupancy": (m.layer_index("occupancy"), ("occupancy",)),
        "mean": (m.layer_index("mean"), ("coord", "count")),
        "covariance": (m.layer_index("covariance"), compare.COV_KEYS)})


def compare(prog: dict, ref: dict, resolution: float) -> dict:
    from ohmbench.reference.compare import ndt_mismatch

    return {**occupancy.compare(prog, ref, resolution),
            "ndt_mismatch_share": ndt_mismatch(prog, ref, resolution)}


def counted(stats: dict) -> dict:
    # Gaussian misses the program turned into standard ones (its miss_k
    # bound): the reference applies the NDT math to every one.
    return {"ndt_overflow": stats["ndt_overflow"]}
