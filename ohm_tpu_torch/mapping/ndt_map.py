"""TorchNdtMap: NDT-OM / NDT-TM ray integration on PyTorch (CUDA or CPU).

Counterpart of ``TpuNdtMap`` (``ohm_tpu/mapping/ndt_map.py``).  It extends
TorchRayMapper with the mean and covariance layers, and in traversability
mode (``NdtParams(ndt_tm=True)``) the intensity and hit/miss count layers;
the rayflow wire carries each ray's intensity, the segmented batch an
intensity array per segment.  A batch takes the segmented wire where the
reference's does: an arena over 8191 regions or a batch outside the rayflow
envelope (STOP_ON_FIRST_OCCUPIED stays on the rayflow wire; it only turns
group-compacted walks into ordered ones).  Per batch the device step is
ops.integrate_ndt.integrate_ndt (the walk front end, kernel K1 with voxel
planes on the rayflow wire; the fused flag gather and K3).  The arena keeps
unobserved occupancy as +inf, as the reference's NDT arena does.

``miss_k`` bounds the Gaussian-bearing miss records that take the NDT math
per batch; flagged records beyond it fall back to standard misses and are
counted in ``stats["ndt_overflow"]``.  The default (65536) sizes itself once
from the fourth batch's flagged count (2x headroom, a power of two, at least
4096) and escalates after an overflow; an int pins it; ``"exact"`` lets
every record through.  With the traversal layer, the flagged records beyond
``miss_k`` drop in compacted-stream order, as the reference's do there.

The map's traversal, touch-time and incident-normal layers integrate as the
reference's NDT mapper integrates them; any other layer stays as the host
map holds it.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ohm_tpu_torch.core.probability import value_to_probability
from ohm_tpu_torch.oracle.ndt import NdtParams, ndt_adaptation_rate_from_miss_probability
from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
from ohm_tpu_torch.ops.config import IntegrateConfig, NdtConfig
from ohm_tpu_torch.ops.integrate_ndt import integrate_ndt
from ohm_tpu_torch.utils.profile import Profile

_PROFILE = Profile.instance()

_AUTO_MISS_K = 1 << 16


class TorchNdtMap(TorchRayMapper):
    """NDT integrator; ``params.ndt_tm`` selects traversability mode."""

    _rayflow_intensity = True
    _stop_needs_segments = False
    _STAT_NAMES = TorchRayMapper._STAT_NAMES + ("ndt_overflow", "ndt_flagged")
    _DROPPED_WHAT = "fused row_cap exceeded: the deposit dropped voxel-lasts"

    def __init__(self, map_obj, params: NdtParams | None = None, capacity: int = 1024,
                 segment_length: float | None = None, validate: bool = False,
                 miss_k: int | str = _AUTO_MISS_K, device="cuda", *,
                 stream_budget: int | None = None, rayflow: bool | None = None):
        """The reference's parameters in its order and with its defaults
        (ndt_map.py:30-32), then ``device``; ``stream_budget`` and
        ``rayflow`` (keyword only) default to None, which reads
        OHM_STREAM_BUDGET and OHM_RAYFLOW as the reference's base class
        does."""
        self.params = params or NdtParams()
        if self.params.adaptation_rate <= 0:
            miss_p = float(value_to_probability(map_obj.miss_value))
            self.params.adaptation_rate = ndt_adaptation_rate_from_miss_probability(miss_p)
        map_obj.layout.add_occupancy()
        map_obj.layout.add_mean()
        map_obj.layout.add_covariance()
        if self.params.ndt_tm:
            map_obj.layout.add_intensity()
            map_obj.layout.add_hit_miss_count()
        if miss_k == "exact":
            self.miss_k = 1 << 30  # K = min(miss_k, stream) is the whole stream
            self._auto_miss_k = False
            self._miss_k_sized = True
        else:
            self.miss_k = int(miss_k)
            self._auto_miss_k = self.miss_k == _AUTO_MISS_K
            self._miss_k_sized = False
        super().__init__(map_obj, capacity=capacity, segment_length=segment_length,
                         validate=validate, rayflow=rayflow, stream_budget=stream_budget,
                         device=device)

    def _arena_layers(self) -> tuple[list[str], str]:
        names = ["occupancy", "mean_coord", "mean_count", "cov"]
        if self.params.ndt_tm:
            names += ["intensity", "hit_count", "miss_count"]
        names += [name for name, on in (("traversal", self.with_traversal),
                                        ("touch_time", self.with_touch),
                                        ("incident", self.with_incident)) if on]
        return names, "inf"

    def _segmented_config(self, prepared, ray_update_flags) -> IntegrateConfig:
        """Group compaction under every flag set (ndt_map.py:175)."""
        return self._config(ray_update_flags, group_cap=self._group_cap(prepared))

    def _ndt_config(self, base: IntegrateConfig) -> NdtConfig:
        p = self.params
        return NdtConfig(
            base=base,
            sensor_noise=float(p.sensor_noise),
            sample_threshold=int(p.sample_threshold),
            adaptation_rate=float(p.adaptation_rate),
            reinit_threshold=float(np.float32(p.reinitialise_covariance_threshold)),
            reinit_count=int(p.reinitialise_covariance_point_count),
            initial_intensity_covariance=float(p.initial_intensity_covariance),
            ndt_tm=bool(p.ndt_tm),
            miss_k=self.miss_k,
        )

    def _integrate_device(self, b: dict, cfg: IntegrateConfig, n_rays: int,
                          n_segments: int) -> dict:
        """One batch through ops.integrate_ndt: with traversal and a row_cap
        that _fused_row_cap_for grants (ndt_map.py:83-88), its standard
        counts take the fused row-local deposit; row_cap and miss_k size
        after the batch (ndt_map.py:121-124)."""
        rc = self._route(cfg, n_rays, n_segments)[0]
        if rc:
            cfg = dataclasses.replace(cfg, row_cap=rc)
        stats = integrate_ndt(self.arena.layers, b, self._ndt_config(cfg))
        self.last_route = stats.pop("route")
        self._auto_size_row_cap(stats, n_segments)
        self._auto_size_miss_k(stats)
        return stats

    def _sizing_pending(self, n_rays: int, n_segments: int) -> bool:
        """row_cap, or the default K before the fourth batch sizes it."""
        return self._row_cap_unsized(n_segments) or self._miss_k_unsized()

    def _miss_k_unsized(self) -> bool:
        """Whether _auto_size_miss_k may still size the default K."""
        return self._auto_miss_k and not self._miss_k_sized

    def _route(self, cfg: IntegrateConfig, n_rays: int, n_segments: int) -> tuple:
        """The route _integrate_device takes: (the fused deposit's row_cap,
        0: K3; the miss phase's K, which _ndt_config reads)."""
        return (self._fused_row_cap_for(n_segments, cfg.group_cap), self.miss_k)

    def _graph_epoch(self) -> tuple:
        """TorchRayMapper's, and the miss phase's K (escalated, it grows)."""
        return super()._graph_epoch() + (self.miss_k,)

    def _auto_size_miss_k(self, stats) -> None:
        """One-time shrink of the default K from the fourth batch's flagged
        count (one read back; 2x headroom, a power of two, at least 4096)."""
        if not self._miss_k_unsized() or self._stats["batches"] < 3:
            return
        with _PROFILE.sync():
            flagged = int(stats["ndt_flagged"])
        k = 4096
        while k < 2 * flagged:
            k *= 2
        self.miss_k = min(self.miss_k, k)
        self._miss_k_sized = True

    def _drain_stats(self) -> list[dict]:
        """As TorchRayMapper's; an overflow of a sized K escalates it once to
        2x the worst batch's demand (capped at the default)."""
        drained = super()._drain_stats()
        worst = max((s["ndt_overflow"] for s in drained), default=0)
        if worst and self._miss_k_sized and self.miss_k < _AUTO_MISS_K:
            k = self.miss_k
            while k < 2 * (self.miss_k + worst) and k < _AUTO_MISS_K:
                k *= 2
            self.miss_k = k
            logging.getLogger("ohm_tpu_torch").warning(
                "NDT miss-phase K overflow (%d records, worst batch %d); "
                "escalating miss_k to %d",
                sum(s["ndt_overflow"] for s in drained), worst, self.miss_k)
        return drained
