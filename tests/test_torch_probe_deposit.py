"""The port's deposit probe (ohm_tpu_torch.scripts.probe_deposit, with
ops.probes_cuda and ops.slotgrid_cuda) against ``scripts/probe_deposit.py``
on the CPU: the same streams, the plain probes against the JAX probes, and
the plain slot-grid deposit against the Pallas kernel in interpret mode,
bit for bit, uncapped counts included.

The JAX script is loaded from its path into a fresh module object whose
globals N, C and LIVE are set for each size; the file is not touched.
"""

import functools
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tpu_torch.ops import probes_cuda
from ohm_tpu_torch.ops.slotgrid_cuda import (HI, LO, TILE, V, onehot_deposit,
                                             scatter_deposit, slotgrid_deposit,
                                             slotgrid_deposit_reference)
from ohm_tpu_torch.scripts import probe_deposit as pd
from ohm_tpu_torch.testing import PROBE_LIBRARY_CALLS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (8192, 8, 5)
MEDIUM = (32768, 16, 10)


@functools.lru_cache(maxsize=None)
def reference(n, c, live):
    """scripts/probe_deposit.py as a fresh module with N, C, LIVE set."""
    spec = importlib.util.spec_from_file_location(f"_probe_deposit_{n}_{c}_{live}",
                                                  os.path.join(REPO, "scripts", "probe_deposit.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path  # the script puts "." in front
    mod.N, mod.C, mod.LIVE = n, c, live
    return mod


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("size", [SMALL, (pd.N, pd.C, pd.LIVE)], ids=["small", "full"])
def test_stream_and_f64_reference_match_the_script(size):
    n, c, live = size
    ref = reference(n, c, live)
    key = pd.make_stream(n, c, live)
    assert np.array_equal(key, ref.make_stream())
    occ0 = pd.initial_occupancy(n, c)[:c * V]
    assert np.array_equal(bits(pd.np_reference(key, occ0, c)), bits(ref.np_reference(key, occ0)))
    flat = key >> 1
    assert np.unique(flat[flat < c * V] >> 15).size == live
    # The sentinel and touched counts follow from the stream itself (numpy's
    # generator draws another stream under other numpy versions): ~2% of the
    # records are sentinel padding, and the live slots' voxels are touched.
    ref_flat = ref.make_stream() >> 1
    sentinels = int((flat == c * V).sum())
    assert sentinels == int((ref_flat == c * V).sum())
    assert abs(sentinels - 0.02 * n) < 5 * np.sqrt(0.02 * n)
    touched = np.unique(flat[flat < c * V]).size
    assert touched == np.unique(ref_flat[ref_flat < c * V]).size
    assert 0 < touched <= min(n - sentinels, live * V)


@pytest.fixture(scope="module")
def jax_probes():
    return reference(*SMALL).probe_lowering(True)


@pytest.mark.parametrize("name", list(probes_cuda.PROBES))
def test_plain_probe_matches_the_jax_probe(jax_probes, name):
    res = probes_cuda.probe_lowering("cpu")
    assert jax_probes[name][0] == "OK"
    assert res[name] == jax_probes[name]
    out = probes_cuda.PROBES[name](*probes_cuda.probe_inputs("cpu")[name])
    assert np.array_equal(out.numpy(), probes_cuda.expected_outputs()[name])
    assert out.numpy().dtype == probes_cuda.expected_outputs()[name].dtype


def pallas_deposit(n, c, keys, occ, variant, fuse_sweep):
    """The reference's slot-grid kernel in interpret mode; f32[c * V]."""
    ref = reference(n, c, 1)
    run = ref.pallas_deposit_build(keys.size // 128, True, grid_c=c, fuse_sweep=fuse_sweep,
                                   variant=variant)
    out = run(jnp.asarray(keys).reshape(-1, 128), jnp.asarray(occ.reshape(c * HI, LO)))
    return np.asarray(out).reshape(-1)


def port_deposit(keys, occ, c, fuse_sweep):
    return slotgrid_deposit(torch.from_numpy(keys), torch.from_numpy(occ.copy()), c,
                            fuse_sweep=fuse_sweep, **pd.SWEEP).numpy()


@pytest.mark.parametrize("size", [SMALL, MEDIUM], ids=["small", "medium"])
@pytest.mark.parametrize("fuse_sweep", [True, False], ids=["fused", "counts"])
@pytest.mark.parametrize("variant", ["base", "cat8"])
def test_plain_slotgrid_matches_the_pallas_kernel(size, fuse_sweep, variant):
    n, c, live = size
    keys = pd.make_stream(n, c, live)
    occ = pd.initial_occupancy(n, c)[:c * V]
    want = pallas_deposit(n, c, keys, occ, variant, fuse_sweep)
    got = port_deposit(keys, occ, c, fuse_sweep)
    assert np.array_equal(bits(got), bits(want))
    flat, hit = keys >> 1, keys & 1
    both = np.intersect1d(flat[(hit == 1) & (flat < c * V)], flat[(hit == 0) & (flat < c * V)])
    assert both.size > 0  # voxels with hits and misses in the batch
    if fuse_sweep:
        assert int((bits(got) != bits(occ)).sum()) > 1000


@pytest.mark.parametrize("fuse_sweep", [True, False], ids=["fused", "counts"])
@pytest.mark.parametrize("name", pd.EDGE_STREAMS)
def test_plain_slotgrid_matches_the_pallas_kernel_on_edge_streams(name, fuse_sweep):
    keys, occ, c = pd.edge_stream(name)
    variant = "cat8" if name == "long_run" else "base"
    want = pallas_deposit(keys.size, c, keys, occ, variant, fuse_sweep)
    got = port_deposit(keys, occ, c, fuse_sweep)
    assert np.array_equal(bits(got), bits(want))
    if name == "all_sentinel":
        assert np.array_equal(bits(got), bits(occ) if fuse_sweep else bits(np.zeros_like(occ)))
    if name == "long_run":
        # Uncapped: the count passes 65535 and the value follows it.
        total = np.float32(pd.LONG_RUN) * np.float32(pd.MISS_VALUE)
        assert got[977] == (np.float32(1.1e4) + total if fuse_sweep else pd.LONG_RUN)
        assert pd.largest_count(torch.from_numpy(keys), c) == pd.LONG_RUN
    if name == "run_across_tiles":
        # Each voxel of ACROSS_TILES: its misses, then its hits from the
        # record given, the first across a 4096-record edge.
        for v, first, misses, hits in pd.ACROSS_TILES:
            run = keys[first:first + misses + hits]
            assert np.all(run >> 1 == v) and keys[first - 1] >> 1 != v
            assert np.array_equal(run & 1, np.repeat([0, 1], [misses, hits]))
            if not fuse_sweep:
                assert got[v] == hits * 65536 + misses
        # The edges are the kernel's tile edges.
        assert 4096 % TILE == 0 and 8192 % TILE == 0
        x, first, misses, _ = pd.ACROSS_TILES[0]
        assert first < 4096 and first + misses == 4096
        y, first, misses, hits = pd.ACROSS_TILES[1]
        assert first + misses < 8192 < first + misses + hits
    if name == "no_sentinel_tail":
        last = keys[-1] >> 1
        assert keys[-1] & 1 and last < c * V and not np.any(keys >> 1 == c * V)
        assert bits(got)[last] != bits(occ)[last]
        if not fuse_sweep:
            assert got[last] == 3 * 65536


def np_sweep_f32(occ, n_hit, n_miss):
    """The probe's sweep in numpy f32, every product and sum rounded once."""
    f = np.float32
    total = n_hit.astype(f) * f(pd.HIT_VALUE) + n_miss.astype(f) * f(pd.MISS_VALUE)
    value = np.where(np.isposinf(occ), f(0), occ) + total
    value = np.where(total > 0, np.minimum(value, f(pd.MAX_VALUE)), value)
    value = np.where(total < 0, np.maximum(value, f(pd.MIN_VALUE)), value)
    return np.where(n_hit + n_miss > 0, value, occ).astype(f)


def test_mixed_voxels_round_every_product_and_sum_once():
    """Voxels that take hits and misses in one batch: the port rounds
    n_hit * hit and the sum separately, as the TPU does.  The Pallas kernel
    in interpret mode runs its sweep through XLA's CPU backend, which may
    contract them into one FMA: it agrees bit for bit elsewhere and, on
    mixed voxels, within the last bits of the total (1e-6 at these
    magnitudes)."""
    keys, occ, c = pd.edge_stream("boundary_in_row")
    flat = (keys >> 1).astype(np.int64)
    hit = np.random.default_rng(4).random(keys.size) < 0.4
    keys = np.sort((flat << 1) | hit).astype(np.int32)
    got = port_deposit(keys, occ, c, True)
    n_hit = np.bincount(flat[hit], minlength=c * V)[:c * V]
    n_miss = np.bincount(flat[~hit], minlength=c * V)[:c * V]
    assert np.array_equal(bits(got), bits(np_sweep_f32(occ, n_hit, n_miss)))
    mixed = (n_hit > 0) & (n_miss > 0)
    assert mixed.sum() >= 100
    want = pallas_deposit(keys.size, c, keys, occ, "base", True)
    assert np.array_equal(bits(got)[~mixed], bits(want)[~mixed])
    np.testing.assert_allclose(got[mixed], want[mixed], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fuse_sweep", [True, False], ids=["fused", "counts"])
def test_plain_slotgrid_counts_nothing_at_or_past_the_slots(fuse_sweep):
    """Keys whose flat lies at or past n_slots * V (the sentinel and beyond)
    or below 0 count nothing, and no element of occ past n_slots * V
    changes."""
    c, rng = 2, np.random.default_rng(5)
    inside = rng.integers(0, c * V, 3000)
    outside = np.concatenate([rng.integers(-40, 0, 20), np.full(60, c * V),
                              rng.integers(c * V + 1, 2**30 - 1, 50), [2**30 - 1]])
    flat = np.concatenate([inside, outside])
    hit = rng.random(flat.size) < 0.3
    keys = np.sort((flat << 1) | hit).astype(np.int32)
    occ = np.full(c * V + 500, np.inf, np.float32)
    occ[c * V:] = rng.normal(0, 5, 500).astype(np.float32)
    got = slotgrid_deposit_reference(torch.from_numpy(keys), torch.from_numpy(occ.copy()), c,
                                     fuse_sweep=fuse_sweep, **pd.SWEEP).numpy()
    assert np.array_equal(bits(got[c * V:]), bits(occ[c * V:]))
    only_inside = np.sort((inside << 1) | hit[:inside.size]).astype(np.int32)
    want = slotgrid_deposit_reference(torch.from_numpy(only_inside),
                                      torch.from_numpy(occ.copy()), c,
                                      fuse_sweep=fuse_sweep, **pd.SWEEP).numpy()
    assert np.array_equal(bits(got), bits(want))
    if not fuse_sweep:
        n_hit = np.bincount(inside[hit[:inside.size]], minlength=c * V)
        n_miss = np.bincount(inside[~hit[:inside.size]], minlength=c * V)
        assert np.array_equal(got[:c * V], (n_hit * 65536 + n_miss).astype(np.float32))


def test_tile_is_the_kernel_source_tile():
    """slotgrid_cuda.TILE, on whose multiples run_across_tiles puts its
    runs, is the keys a block of csrc/slotgrid.cu takes (kThreads * kPer)."""
    path = os.path.join(REPO, "ohm_tpu_torch", "csrc", "slotgrid.cu")
    with open(path) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert re.search(r"constexpr int kTile = kThreads \* kPer;", src)
    assert const("kThreads") * const("kPer") == TILE


@pytest.mark.parametrize("name", [n for n, f in PROBE_LIBRARY_CALLS.items() if callable(f)])
def test_library_yardstick_equals_the_plain_probe(name):
    """Each probe's library call (bincount for the scatter-add and the
    one-hot product, gather for take-along), timed beside the kernel on the
    card, computes the plain version's output: on the probe's inputs, and
    for the one-hot product on random records with 1, 4 and 8 rows and on
    512 records in one cell."""
    lib, plain = PROBE_LIBRARY_CALLS[name], probes_cuda.PLAIN[name]
    cases = [probes_cuda.probe_inputs("cpu")[name]]
    if name == "onehot_mxu_dot":
        rng = np.random.default_rng(6)
        cases += [(torch.from_numpy(rng.integers(0, V, (rows, 128)).astype(np.int32)),)
                  for rows in (1, 4, 8)]
        cases.append((torch.full((4, 128), 12_345, dtype=torch.int32),))
    for args in cases:
        out, want = lib(*args), plain(*args)
        assert out.dtype == want.dtype and out.shape == want.shape
        assert torch.equal(out, want)
    assert all(isinstance(f, str) and f.startswith("none: ")
               for f in PROBE_LIBRARY_CALLS.values() if not callable(f))


@pytest.mark.parametrize("size", [SMALL, MEDIUM], ids=["small", "medium"])
@pytest.mark.parametrize("stage", ["onehot", "scatter"])
def test_plain_onehot_and_scatter_match_xla(stage, size):
    n, c, live = size
    ref = reference(n, c, live)
    keys = pd.make_stream(n, c, live)
    occ_flat = pd.initial_occupancy(n, c)
    kt = torch.from_numpy(keys)
    if stage == "onehot":
        want = ref.xla_onehot_deposit(jnp.asarray(keys),
                                      jnp.asarray(occ_flat[:c * V].reshape(c * HI, LO)))
        got = onehot_deposit(kt, torch.from_numpy(occ_flat[:c * V]), c, **pd.SWEEP)
    else:
        want = ref.xla_scatter_deposit(jnp.asarray(keys), jnp.asarray(occ_flat))
        got = scatter_deposit(kt, torch.from_numpy(occ_flat), c, **pd.SWEEP)
    assert np.array_equal(bits(got.numpy()), bits(np.asarray(want).reshape(-1)))


def test_probe_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pd.main(["--small", "--stages", "probes"])
    with pytest.raises(ValueError, match="unknown stages"):
        pd.main(["--device", "cpu", "--small", "--stages", "lower"])
    out = pd.main(["--device", "cpu", "--small"])
    assert out["ok"] and out["device"] == "cpu"
    assert out["slotgrid"]["bit_mismatches_scatter"] == 0
    assert out["scatter"]["k3_bit_mismatches_scatter"] == 0
    assert out["slotgrid"]["ms"] is None  # the CPU run times nothing
    assert "[onehot_mxu_dot] OK: [1.0, 1.0]" in capsys.readouterr().out
    jax.clear_caches()
