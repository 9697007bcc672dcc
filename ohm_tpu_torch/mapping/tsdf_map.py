"""TorchTsdfMap: truncated signed distance field integration on PyTorch
(CUDA or CPU).

Counterpart of ``TpuTsdfMap`` (``ohm_tpu/mapping/tsdf_map.py``).  It adds
the TSDF layer to the map; its arena holds occupancy (+inf unobserved,
never written: the TSDF mapper updates its own layer only, as the
reference's does), ``tsdf_weight`` and ``tsdf_distance``.  A batch takes
the segmented wire (with t0 and full_length in its float block) where the
reference's does: an arena over 8191 regions or a batch outside the rayflow
envelope.  Layers other than TSDF stay as the host map holds them.  Per
batch the device step is ops.integrate_tsdf.integrate_tsdf (the walk front
end, kernel K1 with voxel planes on the rayflow wire; the fused per-visit
kernel; with ``per_visit=False``, per-voxel sums under the ``scatter_cap``
window).  Ray update flags are ignored, as in the reference's
RayMapperTsdf.
"""

from __future__ import annotations

import dataclasses

from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
from ohm_tpu_torch.ops.config import IntegrateConfig, TsdfConfig
from ohm_tpu_torch.ops.integrate_tsdf import integrate_tsdf
from ohm_tpu_torch.oracle.tsdf import TsdfOptions


class TorchTsdfMap(TorchRayMapper):
    """TSDF integrator; ``options`` are the reference's TsdfOptions."""

    _stop_needs_segments = False
    _DROPPED_WHAT = ("scatter_cap exceeded (the per-batch deposit window): "
                     "raise TorchTsdfMap(scatter_cap=...)")

    def __init__(self, map_obj, options: TsdfOptions | None = None, capacity: int = 1024,
                 segment_length: float | None = None, validate: bool = False,
                 scatter_cap: int | str = "auto", device="cuda", *,
                 stream_budget: int | None = None, rayflow: bool | None = None):
        """The reference's parameters in its order and with its defaults
        (tsdf_map.py:23-25), then ``device``; ``stream_budget`` and
        ``rayflow`` (keyword only) default to None, which reads
        OHM_STREAM_BUDGET and OHM_RAYFLOW as the reference's base class
        does.  ``scatter_cap`` is the ``per_visit=False`` deposit window
        (ops.integrate_tsdf): "auto" sizes it from the fourth batch's
        touched count as the occupancy mapper sizes its own, an int pins
        it, 0 disables; the per-visit route deposits without a window."""
        self.options = options or TsdfOptions()
        map_obj.layout.add_tsdf()
        super().__init__(map_obj, capacity=capacity, segment_length=segment_length,
                         validate=validate, scatter_cap=scatter_cap, rayflow=rayflow,
                         stream_budget=stream_budget, device=device)

    def _arena_layers(self) -> tuple[list[str], str]:
        return ["occupancy", "tsdf_weight", "tsdf_distance"], "inf"

    def _segmented_config(self, prepared, ray_update_flags) -> IntegrateConfig:
        """Flags ignored, the TSDF float block (tsdf_map.py:30-34)."""
        return dataclasses.replace(self._config(0, group_cap=self._group_cap(prepared)),
                                   wire_tsdf=True)

    def _tsdf_config(self, base: IntegrateConfig) -> TsdfConfig:
        o = self.options
        return TsdfConfig(
            base=base,
            max_weight=float(o.max_weight),
            default_truncation_distance=float(o.default_truncation_distance),
            dropoff_epsilon=float(o.dropoff_epsilon),
            sparsity_compensation_factor=float(o.sparsity_compensation_factor),
            per_visit=bool(o.per_visit),
        )

    def _sizing_pending(self, n_rays: int, n_segments: int) -> bool:
        """The ``per_visit=False`` window before it is sized."""
        return self._scatter_cap_unsized(n_rays)

    def _route(self, cfg: IntegrateConfig, n_rays: int, n_segments: int) -> tuple:
        """One route: the config holds all the device step reads."""
        return ()

    def _integrate_device(self, b: dict, cfg: IntegrateConfig, n_rays: int,
                          n_segments: int) -> dict:
        self.last_route = "tsdf"
        stats = integrate_tsdf(self.arena.layers, b, self._tsdf_config(cfg))
        self._auto_size_scatter_cap(stats, n_rays)
        return stats
