"""Static configuration of one integrate call (rayflow or segmented wire).

``IntegrateConfig`` is the counterpart of ``IntegrateConfig`` in
``ohm_tpu/ops/integrate.py``, holding only the fields the port's paths read.
The Pallas switches (``pallas_*``) are left out: the port's kernels run
wherever the reference's would on a TPU.  ``NdtConfig`` and ``TsdfConfig`` are the
counterparts of ``NdtConfig`` in ``ohm_tpu/ops/integrate_ndt.py`` and
``TsdfConfig`` in ``ohm_tpu/ops/integrate_tsdf.py``.

The occupancy path's arena encodes "unobserved" as -0.0 (the reference's
``zero_unobserved`` mode); the NDT path's arena keeps +inf, as the
reference's NDT arena does, and so does the TSDF path's.
"""

from __future__ import annotations

import dataclasses

# The segmented wire's full per-segment blocks (mapping.batch.PreparedBatch,
# as ohm_tpu/ops/integrate.py lays them out):
#   ints  i32[B, 17]: start_abs xyz | end_abs xyz | rmin xyz | corner_slots[8]
#   floats f32[B, 12]: start_frac xyz | direction xyz | length | end_frac xyz
#                      | t0 | full_length
#   flags bool[B, 4]: is_sample | end_as_miss | exclude_start | valid
INTS_WIDTH = 17
FLOATS_WIDTH = 12
FLAGS_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class IntegrateConfig:
    resolution: float
    region_shift: int  # log2(region voxel dim); dims are cubic powers of two
    capacity: int  # arena capacity in regions
    max_steps: int  # per-axis event cap S of the walk (record axis is 3S)
    ray_flags: int = 0
    # Layer presence (the occupancy mapper's side layers):
    with_mean: bool = False
    with_traversal: bool = False
    with_touch_time: bool = False
    with_incident: bool = False
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
    #: Record-axis cap of the ordered walk (ops.ddawalk.walk_rays): the
    #: rayflow host sets it from the batch's exact maximum total crossings;
    #: 0 takes walk_total_cap(max_steps), a bound only for the segmented
    #: wire's one-region-edge segments.  The rank walk emits 3S records per
    #: ray and does not truncate.
    walk_cap: int = 0
    #: Rayflow dictionary modes (mapping.batch.rayflow_wire): candidates as
    #: full i32 (0), u8 indices into a 256-entry dict (1) or u16 indices into
    #: a 2048-entry dict (2); start_frac as a 256-entry dict + u8 index.
    rayw_cdict: int = 0
    rayw_fdict: bool = False
    #: The wire carries a per-ray f32 intensity block (the NDT mappers); it
    #: carries a per-ray u32 touch-time block when ``with_touch_time``.
    rayw_intensity: bool = False
    #: The rank walk (ops.ddawalk.walk_rays_unordered, or K1 on the rayflow
    #: wire) under group compaction; otherwise the ordered walk (never with
    #: STOP_ON_FIRST_OCCUPIED, which needs each ray's records in time order).
    unordered_walk: bool = False
    #: The segmented wire's float block carries t0 and full_length (width
    #: 12, the TSDF mapper's); else end_frac with the mean layer (10) or
    #: neither (7).
    wire_tsdf: bool = False
    #: The delta path's window (ops.integrate.apply_delta): touched voxels
    #: past it in a batch are dropped and counted in
    #: stats['dropped_updates'].  0 = no window (and no delta path).
    scatter_cap: int = 0
    #: The reference's scratch tail length: the largest delta window and
    #: the largest fused merge stream (it clamps the fused row window,
    #: ops.integrate.apply_records_fused).  The port's arena has no tail:
    #: its pad entries add the identity at spread voxels
    #: (ops.integrate._pad_targets).
    scatter_pad: int = 1 << 22
    #: The fused row-local apply's unique-voxel budget per compaction row
    #: (ops.integrate.apply_records_fused); 0 runs the split apply.
    row_cap: int = 0

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


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    """Static TSDF parameters layered over the base integrate config
    (reference: ohm/VoxelTsdf.h:27-37)."""

    base: IntegrateConfig
    max_weight: float = 1e4
    default_truncation_distance: float = 0.1
    dropoff_epsilon: float = 0.0
    sparsity_compensation_factor: float = 1.0
    #: Apply truncation at every visit in ray order (the reference's exact
    #: semantics) instead of once per batch.
    per_visit: bool = True
