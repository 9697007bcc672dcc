"""ohmpop ``--mode occupancy``: the occupancy log-odds of every observed
voxel."""

from __future__ import annotations

#: Voxels that disagree with the reference, and rays submitted but not
#: counted by the program.
NUMBERS = ("voxel_mismatch_share", "rays_lost")
#: The arena layers whose values the comparison reads.
VALUE_LAYERS = ("occupancy",)


def grid_and_params(config: dict):
    """The reference's voxel grid and occupancy update of the configuration."""
    from ohmbench.reference.occupancy import OccupancyParams
    from ohmbench.reference.walk import Grid

    grid = Grid(config["resolution"], config["region_dim"])
    params = OccupancyParams.from_probabilities(config["hit_probability"],
                                                config["miss_probability"])
    return grid, params


def precisions(config: dict, geometry=None, values=None) -> tuple:
    """(geometry, values) dtypes: those given, else the configuration's."""
    import torch

    return (geometry or getattr(torch, config["precision"]["geometry"]),
            values or getattr(torch, config["precision"]["voxel_values"]))


def make_reference(config: dict, geometry=None, values=None):
    from ohmbench.reference.occupancy import OccupancyReference

    grid, params = grid_and_params(config)
    return OccupancyReference(grid, params, *precisions(config, geometry, values))


def read_layers(m, config: dict, device, layers: dict) -> dict:
    """The host map's ``layers`` ({name: (layer index, members)}) in the
    reference's form."""
    from ohmbench.reference import compare

    chunks = {key: {f"{name}.{member}": c.layers[index][member]
                    for name, (index, members) in layers.items() for member in members}
              for key, c in m.chunks.items()}
    return compare.read_map(chunks, config["region_dim"], config["resolution"], device)


def program_map(m, config: dict, device) -> dict:
    return read_layers(m, config, device,
                       {"occupancy": (m.layer_index("occupancy"), ("occupancy",))})


def compare(prog: dict, ref: dict, resolution: float) -> dict:
    from ohmbench.reference.compare import mismatch

    return {"voxel_mismatch_share": mismatch(prog["ids"], prog["occupancy"],
                                             ref["ids"], ref["occupancy"])}


def counted(stats: dict) -> dict:
    return {}
