"""Static configuration of one integrate call (rayflow wire).

``IntegrateConfig`` is the counterpart of ``IntegrateConfig`` in
``ohm_tpu/ops/integrate.py``, holding only the fields the port's path reads.
The TPU switches (``scatter_cap``, ``row_cap``, ``pallas_*``, the scatter
tail) and the layers the port does not have yet (traversal, touch time,
incident, TSDF) are left out.  ``NdtConfig`` is the counterpart of
``ohm_tpu/ops/integrate_ndt.py`` ``NdtConfig``.

The occupancy path's arena encodes "unobserved" as -0.0 (the reference's
``zero_unobserved`` mode); the NDT path's arena keeps +inf, as the
reference's NDT arena does.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IntegrateConfig:
    resolution: float
    region_shift: int  # log2(region voxel dim); dims are cubic powers of two
    capacity: int  # arena capacity in regions
    max_steps: int  # per-axis event cap S of the walk (record axis is 3S)
    ray_flags: int = 0
    # Probability model (f32 values held as Python floats):
    hit_value: float = 0.0
    miss_value: float = 0.0
    occupancy_threshold: float = 0.0
    min_value: float = 0.0
    max_value: float = 0.0
    saturation_min: float = float("-inf")
    saturation_max: float = float("inf")
    #: Group compaction of the walk key stream: rows of ``group_size`` rays
    #: (strided, ops.integrate.group_rows) are sorted and cut to
    #: ``group_cap`` keys.  The host sizes the cap from exact crossing counts,
    #: so the cut drops only sentinel padding; stats['compaction_dropped']
    #: counts violations.  0 disables.
    group_cap: int = 0
    group_size: int = 64
    #: Candidate-table width K of the rayflow wire.
    table_k: int = 0
    #: Walk cap from the batch's exact maximum total crossings.  Carried for
    #: parity with the reference's configuration; the rank walk emits 3S
    #: records per ray and does not truncate.
    walk_cap: int = 0
    #: Rayflow dictionary modes (mapping.batch.rayflow_wire): candidates as
    #: full i32 (0), u8 indices into a 256-entry dict (1) or u16 indices into
    #: a 2048-entry dict (2); start_frac as a 256-entry dict + u8 index.
    rayw_cdict: int = 0
    rayw_fdict: bool = False
    #: The wire carries a per-ray f32 intensity block (the NDT mappers).
    rayw_intensity: bool = False

    def __post_init__(self):
        # Flat arena addresses and sort keys are int32; the key packs
        # (flat << 1 | hit), so capacity * voxels_per_region < 2^30.
        if ((self.sentinel << 1) | 1) > 2**31 - 1:
            raise ValueError(
                f"arena capacity {self.capacity} x {self.voxels_per_region} voxels/region "
                f"overflows the int32 sort key (need capacity * voxels_per_region < 2^30)")

    @property
    def voxels_per_region(self) -> int:
        return 1 << (3 * self.region_shift)

    @property
    def sentinel(self) -> int:
        return self.capacity * self.voxels_per_region


@dataclasses.dataclass(frozen=True)
class NdtConfig:
    """Static NDT parameters layered over the base integrate config."""

    base: IntegrateConfig
    sensor_noise: float = 0.05
    sample_threshold: int = 3
    adaptation_rate: float = 0.4
    reinit_threshold: float = -1.3862944  # probabilityToValue(0.2)
    reinit_count: int = 100
    initial_intensity_covariance: float = 1.0
    ndt_tm: bool = False
    #: Budget of Gaussian-bearing miss records per batch (the K stream).
    miss_k: int = 1 << 16
