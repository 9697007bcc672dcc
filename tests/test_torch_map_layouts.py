"""The port's mappers take any map layout, as the reference's do: each
integrates the layers it knows and leaves every other layer as the host map
holds it (ohm_tpu/mapping/tpu_map.py:90-106).

On a 0.1 m map with 32^3 regions carrying one more layer (a clearance layer
as ClearanceProcess adds it, secondary samples, covariance under the
occupancy mapper, intensity under NDT-OM), TorchRayMapper and TorchNdtMap
on the CPU run beside TpuRayMapper and TpuNdtMap (rayflow wire, split-phase
apply, XLA branch): the wire bytes and K1's walk keys are equal, occupancy
bit-identical (NDT within atol = rtol = 1e-5: the jitted reference
contracts into FMAs), and the extra layer, filled with seeded bytes between
the two batches, keeps them in both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ohm_tpu.mapping.ndt_map as ref_ndt_map
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.mapping.ndt_map import TpuNdtMap
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.ops import expand_pallas
from ohm_tpu.ops.integrate import _unpack_batch
from ohm_tpu_torch import TorchNdtMap, TorchRayMapper
from ohm_tpu_torch.core.map import MapFlag as PortMapFlag
from ohm_tpu_torch.core.map import OccupancyMap as PortMap
from ohm_tpu_torch.ops import expand_cuda
from ohm_tpu_torch.ops.wire import unpack_batch

CASES = [("occupancy", "clearance"), ("occupancy", "secondary_samples"),
         ("occupancy", "covariance"), ("ndt", "clearance"), ("ndt", "secondary_samples"),
         ("ndt", "intensity")]


def _batches():
    rng = np.random.default_rng(41)
    out = []
    for _ in range(2):
        rays = np.zeros((128, 3))
        rays[1::2] = rng.uniform(-2.0, 2.0, (64, 3))
        out.append(rays)
    return out


def _fill(m, layer: str) -> dict:
    """Seeded bytes in every member of ``layer`` of every chunk; returns
    them by (region, member)."""
    li = m.layer_index(layer)
    out = {}
    for key in sorted(m.chunks):
        arr = m.chunks[key].layers[li]
        seed = abs(hash(key)) % (1 << 31)
        for name in arr.dtype.names:
            raw = np.random.default_rng(seed).integers(0, 255, arr[name].nbytes, dtype=np.uint8)
            arr[name] = raw.view(arr[name].dtype).reshape(arr[name].shape)
            out[(key, name)] = np.array(arr[name])
            seed += 1
    return out


def _run(kind: str, layer: str, port: bool):
    """Both batches through one package's mapper, the extra layer filled
    between them; returns (host map, filled bytes, wires, last cfg)."""
    wires, cfgs = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_FUSED", "0")
        mp.setenv("OHM_PALLAS", "0")
        mp.setenv("OHM_EXPAND", "0")
        m = (PortMap if port else OccupancyMap)(resolution=0.1, region_voxel_dims=32,
                                                  flags=(PortMapFlag if port else MapFlag).NONE)
        getattr(m.layout, f"add_{layer}")()
        if port:
            mapper = (TorchNdtMap if kind == "ndt" else TorchRayMapper)(
                m, capacity=16, validate=True, device="cpu", rayflow=True)
            inner = mapper._dispatch

            def dispatch(wire, cfg, n_rays):
                wires.append(wire.numpy().copy())
                cfgs.append(cfg)
                return inner(wire, cfg, n_rays)

            mapper._dispatch = dispatch
        else:
            if kind == "ndt":
                mapper = TpuNdtMap(m, capacity=16, validate=True)
                mapper.rayflow = True
                inner_jit = ref_ndt_map.integrate_ndt_jit

                def jit(arena, batch, cfg):
                    wires.append(np.array(batch["rayw"]))
                    cfgs.append(cfg.base)
                    return inner_jit(arena, batch, cfg)

                mp.setattr(ref_ndt_map, "integrate_ndt_jit", jit)
            else:
                mapper = TpuRayMapper(m, capacity=16, validate=True, rayflow=True,
                                      scatter_cap=0)
                inner = mapper._dispatch_rayflow

                def dispatch(batch, cfg, n_rays, flags):
                    wires.append(np.array(batch["rayw"]))
                    cfgs.append(cfg)
                    return inner(batch, cfg, n_rays, flags)

                mapper._dispatch_rayflow = dispatch
        first, second = _batches()
        mapper.prime_caps([first, second])
        mapper.integrate_rays(first)
        mapper.sync_voxels()
        filled = _fill(m, layer)
        mapper.integrate_rays(second)
        mapper.sync_voxels()
    return m, filled, wires, cfgs[-1]


@pytest.mark.parametrize("kind,layer", CASES)
def test_mapper_leaves_other_layers_to_the_host(kind, layer):
    (m_r, filled_r, wires_r, jcfg), (m_p, filled_p, wires_p, pcfg) = (
        _run(kind, layer, port) for port in (False, True))
    assert len(wires_r) == len(wires_p) == 2
    for a, b in zip(wires_r, wires_p):
        assert np.array_equal(a, b)
    ref_key = expand_pallas.expand_keys(_unpack_batch({"rayw": jnp.asarray(wires_r[-1])}, jcfg),
                                        jcfg, interpret=True)[0]
    key, _ = expand_cuda.expand_keys(unpack_batch(torch.from_numpy(wires_p[-1]), pcfg), pcfg)
    assert np.array_equal(np.asarray(ref_key), key.numpy())
    assert int((key != pcfg.sentinel).sum()) > 100
    assert m_r.chunks.keys() == m_p.chunks.keys() and len(m_p.chunks) > 1
    oi_r, oi_p = m_r.layer_index("occupancy"), m_p.layer_index("occupancy")
    for key in m_r.chunks:
        a = m_r.chunks[key].layers[oi_r]["occupancy"]
        b = m_p.chunks[key].layers[oi_p]["occupancy"]
        if kind == "ndt":
            assert np.array_equal(np.isinf(a), np.isinf(b))
            np.testing.assert_allclose(b[np.isfinite(a)], a[np.isfinite(a)], atol=1e-5, rtol=1e-5)
        else:
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # The extra layer holds the bytes it was given, in both packages.
    assert filled_r.keys() == filled_p.keys() and filled_p
    li_r, li_p = m_r.layer_index(layer), m_p.layer_index(layer)
    for (key, name), want in filled_p.items():
        want = _bytes(want)
        assert np.array_equal(want, _bytes(filled_r[(key, name)]))
        assert np.array_equal(_bytes(m_p.chunks[key].layers[li_p][name]), want), (key, name)
        assert np.array_equal(_bytes(m_r.chunks[key].layers[li_r][name]), want), (key, name)


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)
