"""TorchNdtMap: NDT-OM / NDT-TM ray integration on PyTorch (CUDA or CPU).

Counterpart of ``TpuNdtMap`` (``ohm_tpu/mapping/ndt_map.py``) on the rayflow
wire.  It extends TorchRayMapper with the mean and covariance layers, and in
traversability mode (``NdtParams(ndt_tm=True)``) the intensity and hit/miss
count layers; the wire carries each ray's intensity.  Per batch the device
step is ops.integrate_ndt.integrate_ndt (kernels K1 with voxel planes, K4
and K3).  The arena keeps unobserved occupancy as +inf, as the reference's
NDT arena does.

``miss_k`` bounds the Gaussian-bearing miss records that take the NDT math
per batch; flagged records beyond it fall back to standard misses and are
counted in ``stats["ndt_overflow"]``.  The default (65536) sizes itself once
from the fourth batch's flagged count (2x headroom, a power of two, at least
4096) and escalates after an overflow; an int pins it; ``"exact"`` lets
every record through.  Traversal, touch time and incident layers under NDT
raise NotImplementedError (not ported yet).
"""

from __future__ import annotations

import logging

import numpy as np

from ohm_tpu.core.layout import (COVARIANCE_LAYER, HIT_MISS_COUNT_LAYER,
                                 INTENSITY_LAYER, MEAN_LAYER, OCCUPANCY_LAYER)
from ohm_tpu.core.probability import value_to_probability
from ohm_tpu.oracle.ndt import NdtParams, ndt_adaptation_rate_from_miss_probability
from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
from ohm_tpu_torch.ops.config import IntegrateConfig, NdtConfig
from ohm_tpu_torch.ops.integrate_ndt import integrate_ndt

_AUTO_MISS_K = 1 << 16


class TorchNdtMap(TorchRayMapper):
    """NDT integrator; ``params.ndt_tm`` selects traversability mode."""

    _rayflow_intensity = True
    _STAT_NAMES = TorchRayMapper._STAT_NAMES + ("ndt_overflow", "ndt_flagged")

    def __init__(self, map_obj, params: NdtParams | None = None, capacity: int = 1024,
                 validate: bool = False, miss_k: int | str = _AUTO_MISS_K,
                 stream_budget: int = 1 << 21, device="cuda"):
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
        super().__init__(map_obj, capacity=capacity, validate=validate,
                         stream_budget=stream_budget, device=device)

    def _check_layers(self, map_obj) -> None:
        allowed = {OCCUPANCY_LAYER, MEAN_LAYER, COVARIANCE_LAYER}
        if self.params.ndt_tm:
            allowed |= {INTENSITY_LAYER, HIT_MISS_COUNT_LAYER}
        others = [layer.name for layer in map_obj.layout.layers if layer.name not in allowed]
        if others:
            raise NotImplementedError(
                f"map layers {others} under NDT are not ported yet")

    def _arena_layers(self) -> tuple[list[str], str]:
        names = ["occupancy", "mean_coord", "mean_count", "cov"]
        if self.params.ndt_tm:
            names += ["intensity", "hit_count", "miss_count"]
        return names, "inf"

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

    def _integrate_device(self, b: dict, cfg: IntegrateConfig) -> dict:
        stats = integrate_ndt(self.arena.layers, b, self._ndt_config(cfg))
        self._auto_size_miss_k(stats)
        return stats

    def _auto_size_miss_k(self, stats) -> None:
        """One-time shrink of the default K from the fourth batch's flagged
        count (one read back; 2x headroom, a power of two, at least 4096)."""
        if not self._auto_miss_k or self._miss_k_sized or self._stats["batches"] < 3:
            return
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
