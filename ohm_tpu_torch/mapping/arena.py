"""Device voxel arena: every layer of every resident region in one flat
tensor per layer, with LRU paging to the host map.

Counterpart of ``VoxelArena`` in ``ohm_tpu/mapping/arena.py`` for the layers
the port has: occupancy, and for NDT mean (``mean_coord``, ``mean_count``),
covariance ``cov`` [N,6], and for NDT-TM ``intensity`` [N,2],
``hit_count`` and ``miss_count``.  Each layer holds ``capacity * V + 1``
voxels on its device: region slot s owns ``[s*V, (s+1)*V)``, and the last
element is the sentinel that dropped records address (no kernel writes it).
The reference's 512-multiple padding and scatter tail served Pallas and the
XLA scatter; the CUDA kernels need neither.

Two occupancy encodings, as in the reference: "zero" (the occupancy mapper)
holds unobserved voxels as -0.0 on the device; "inf" (the NDT mapper) keeps
the host's +inf.  Every host transfer converts.  The u32 layers are stored
as int32 bit patterns (torch has no trustworthy uint32 arithmetic) and are
reinterpreted at the host boundary, never converted through float.  The host
keeps the authoritative region -> slot directory
(ops.regiontable.HostRegionTable, read by the native wire pass).
"""

from __future__ import annotations

import numpy as np
import torch

from ohm_tpu.core import layout as layoutmod
from ohm_tpu_torch.ops.regiontable import HostRegionTable


class NeedsEviction(RuntimeError):
    """Raised by ensure_regions(allow_evict=False) when allocation would
    have to evict (kept for the reference's batched submission, which
    must not reassign a slot that a prepared wire still references)."""


class CacheFull(RuntimeError):
    """A single batch demands more regions than the arena can hold; the
    mapper splits the batch and retries (ohmgpu/GpuMap.cpp:922-1017)."""


#: Arena layers: name -> (device dtype, host dtype, width or None).  The
#: u32 layers live as int32 bit patterns; every clear value is 0 except
#: occupancy's, which the encoding sets.
LAYER_SPECS = {
    "occupancy": (torch.float32, np.float32, None),
    "mean_coord": (torch.int32, np.uint32, None),
    "mean_count": (torch.int32, np.uint32, None),
    "cov": (torch.float32, np.float32, 6),  # packed lower-triangular sqrt cov
    "intensity": (torch.float32, np.float32, 2),  # mean, cov
    "hit_count": (torch.int32, np.uint32, None),
    "miss_count": (torch.int32, np.uint32, None),
}

_COV_MEMBERS = ("P00", "P01", "P11", "P02", "P12", "P22")
#: Scalar layers stored in one member of a host layer.
_HOST_MEMBERS = {
    "occupancy": (layoutmod.OCCUPANCY_LAYER, "occupancy"),
    "mean_coord": (layoutmod.MEAN_LAYER, "coord"),
    "mean_count": (layoutmod.MEAN_LAYER, "count"),
    "hit_count": (layoutmod.HIT_MISS_COUNT_LAYER, "hit_count"),
    "miss_count": (layoutmod.HIT_MISS_COUNT_LAYER, "miss_count"),
}


def encode_occupancy(host_data: np.ndarray) -> np.ndarray:
    """Host values (+inf = unobserved) -> "zero" arena values (-0.0)."""
    return np.where(np.isposinf(host_data), np.float32(-0.0),
                    host_data).astype(np.float32)


def decode_occupancy(device_data: np.ndarray) -> np.ndarray:
    """"zero" arena values (-0.0 = unobserved) -> host values (+inf)."""
    unobs = (device_data == 0) & np.signbit(device_data)
    return np.where(unobs, np.float32(np.inf), device_data).astype(np.float32)


class VoxelArena:
    """Fixed-capacity device store of map regions for a set of layers."""

    def __init__(self, capacity: int, region_shift: int, device: torch.device,
                 layer_names=("occupancy",), occupancy_encoding: str = "zero"):
        if occupancy_encoding not in ("inf", "zero"):
            raise ValueError(f"unknown occupancy encoding {occupancy_encoding!r}")
        unknown = set(layer_names) - set(LAYER_SPECS)
        if unknown or "occupancy" not in layer_names:
            raise ValueError(f"arena layers must include occupancy and come from "
                             f"{sorted(LAYER_SPECS)}; got {list(layer_names)}")
        self.occupancy_encoding = occupancy_encoding
        self.capacity = int(capacity)
        self.region_shift = int(region_shift)
        self.voxels_per_region = 1 << (3 * region_shift)
        self.device = device
        self.layer_names = list(layer_names)
        self.table = HostRegionTable()
        self.slot_of: dict[tuple[int, int, int], int] = {}
        self.region_of: list = [None] * self.capacity
        self.free_slots = list(range(self.capacity - 1, -1, -1))
        self.last_used = np.zeros(self.capacity, dtype=np.int64)
        self.batch_counter = 0
        #: Region lookups that found a resident slot, allocations, evictions.
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}
        n = self.capacity * self.voxels_per_region + 1
        self.layers: dict[str, torch.Tensor] = {}
        for name in self.layer_names:
            dtype, _, width = LAYER_SPECS[name]
            shape = (n, width) if width else (n,)
            self.layers[name] = torch.full(shape, self._clear(name), dtype=dtype,
                                           device=device)

    @property
    def occupancy(self) -> torch.Tensor:
        return self.layers["occupancy"]

    def _clear(self, name: str) -> float:
        if name != "occupancy":
            return 0
        return -0.0 if self.occupancy_encoding == "zero" else float("inf")

    def _to_device(self, name: str, host: np.ndarray) -> np.ndarray:
        """Host layer values -> the arena's representation (numpy)."""
        if name == "occupancy":
            host = np.asarray(host, np.float32)
            return encode_occupancy(host) if self.occupancy_encoding == "zero" else host
        if LAYER_SPECS[name][1] == np.uint32:
            return np.ascontiguousarray(host, dtype=np.uint32).view(np.int32)
        return np.ascontiguousarray(host, dtype=np.float32)

    def _to_host(self, name: str, dev: np.ndarray) -> np.ndarray:
        """The arena's representation (numpy) -> host layer values."""
        if name == "occupancy" and self.occupancy_encoding == "zero":
            return decode_occupancy(dev)
        if LAYER_SPECS[name][1] == np.uint32:
            return dev.view(np.uint32)
        return dev

    def ensure_regions(self, region_keys: np.ndarray, host_map=None,
                       allow_evict: bool = True):
        """Allocate arena slots for every region in (R, 3); evict the least
        recently used regions (spilled to ``host_map``) when full.

        Regions used by this batch are pinned.  Raises CacheFull when the
        batch alone needs more regions than the arena holds, NeedsEviction
        when eviction is needed and not allowed."""
        self.batch_counter += 1
        keys = np.asarray(region_keys, dtype=np.int64).reshape(-1, 3)
        missing = []
        for key in map(tuple, keys):
            key = (int(key[0]), int(key[1]), int(key[2]))
            slot = self.slot_of.get(key)
            if slot is not None:
                self.last_used[slot] = self.batch_counter
                self.stats["hits"] += 1
            else:
                missing.append(key)
        if not missing:
            return
        self.stats["misses"] += len(missing)
        need = len(missing) - len(self.free_slots)
        if need > 0 and not allow_evict:
            raise NeedsEviction(f"{need} evictions required")
        if need > 0:
            last = self.last_used
            cand = np.flatnonzero(
                (last < self.batch_counter)
                & np.fromiter((r is not None for r in self.region_of),
                              dtype=bool, count=self.capacity))
            if len(cand) < need:
                raise CacheFull(
                    f"batch demands more regions than the arena holds "
                    f"(capacity {self.capacity}, short by {need - len(cand)})")
            victims = cand[np.argpartition(last[cand], need - 1)[:need]]
            for slot in victims.tolist():
                self.stats["evictions"] += 1
                key = self.region_of[slot]
                if host_map is not None:
                    self._download_region(host_map, key, slot)
                self.table.remove(key)
                del self.slot_of[key]
                self.region_of[slot] = None
                self.free_slots.append(slot)
        for key in missing:
            slot = self.free_slots.pop()
            self.slot_of[key] = slot
            self.region_of[slot] = key
            self.last_used[slot] = self.batch_counter
            self.table.insert(key, slot)
            if host_map is not None and host_map.region(key) is not None:
                self._upload_region(host_map, key, slot)

    # ------------------------------------------------------------------ #
    # Host <-> device region transfer

    def _slot_slice(self, slot: int) -> slice:
        v = self.voxels_per_region
        return slice(slot * v, (slot + 1) * v)

    def _upload_region(self, host_map, key, slot: int):
        """Push a host chunk's layers into the arena slot."""
        chunk = host_map.region(key)
        sl = self._slot_slice(slot)
        for name, data in _read_host_chunk(host_map, chunk, self.layer_names).items():
            self.layers[name][sl] = torch.from_numpy(
                self._to_device(name, data)).to(self.device)

    def _download_region(self, host_map, key, slot: int):
        """Pull one arena slot back into the host map chunk and clear it."""
        sl = self._slot_slice(slot)
        pulled = {name: self._to_host(name, t[sl].cpu().numpy())
                  for name, t in self.layers.items()}
        _write_host_chunk(host_map, host_map.region(key, allow_create=True), pulled)
        for name, t in self.layers.items():
            t[sl] = self._clear(name)

    def sync_to_host(self, host_map, stamp=None):
        """Download every resident region that holds a touched voxel into
        the host map (GpuMap::syncVoxels)."""
        pulled_all = {name: self._to_host(name, t.cpu().numpy())
                      for name, t in self.layers.items()}
        v = self.voxels_per_region
        for key, slot in self.slot_of.items():
            pulled = {name: a[slot * v:(slot + 1) * v] for name, a in pulled_all.items()}
            if _region_untouched(pulled):
                continue
            chunk = host_map.region(key, allow_create=True)
            _write_host_chunk(host_map, chunk, pulled)
            if stamp is not None:
                chunk.dirty_stamp = stamp
                chunk.touched_stamps[:] = stamp


def arena_from_reference(arrays: dict, capacity: int, region_shift: int,
                         device, directory=None) -> VoxelArena:
    """The port's NDT ("inf"-encoded) arena holding the state of a JAX NDT
    ``VoxelArena`` (also "inf"-encoded).

    ``arrays`` maps layer names to the reference arena's arrays as numpy
    (``{k: np.asarray(v) for k, v in ref.arrays.items()}``); their scratch
    tail and 512-multiple padding are cut to ``capacity * V + 1`` voxels and
    the u32 layers become int32 bit patterns.  ``directory``, when given, is
    an arena (either package's) whose region -> slot directory, LRU state
    and stats are copied too."""
    names = [n for n in LAYER_SPECS if n in arrays]
    arena = VoxelArena(capacity, region_shift, device, names, "inf")
    n = arena.capacity * arena.voxels_per_region + 1
    for name in names:
        data = arena._to_device(name, np.asarray(arrays[name])[:n])
        arena.layers[name] = torch.from_numpy(np.array(data)).to(device)
    if directory is not None:
        arena.slot_of = dict(directory.slot_of)
        arena.region_of = list(directory.region_of)
        arena.free_slots = list(directory.free_slots)
        arena.last_used = np.array(directory.last_used, dtype=np.int64)
        arena.batch_counter = int(directory.batch_counter)
        arena.stats = dict(directory.stats)
        for key, slot in arena.slot_of.items():
            arena.table.insert(key, slot)
    return arena


def _region_untouched(pulled: dict) -> bool:
    """True when every pulled (host-valued) layer still holds its clear
    value: +inf occupancy, 0 elsewhere."""
    for name, data in pulled.items():
        if name == "occupancy":
            if not np.all(np.isinf(data)):
                return False
        elif not np.all(data == 0):
            return False
    return True


def _read_host_chunk(host_map, chunk, names) -> dict:
    """A host chunk's values of the arena layers ``names`` its map has."""
    lay = host_map.layout
    out = {}
    for name in names:
        if name in _HOST_MEMBERS:
            layer, member = _HOST_MEMBERS[name]
            idx = lay.layer_index(layer)
            if idx >= 0:
                out[name] = np.ascontiguousarray(chunk.layers[idx][member])
        elif name == "cov":
            idx = lay.layer_index(layoutmod.COVARIANCE_LAYER)
            if idx >= 0:
                arr = chunk.layers[idx]
                out[name] = np.stack([arr[m] for m in _COV_MEMBERS], axis=-1)
        elif name == "intensity":
            idx = lay.layer_index(layoutmod.INTENSITY_LAYER)
            if idx >= 0:
                arr = chunk.layers[idx]
                out[name] = np.stack([arr["mean"], arr["cov"]], axis=-1)
    return out


def _write_host_chunk(host_map, chunk, pulled: dict):
    """Store a slot's host-valued layers into a host chunk."""
    lay = host_map.layout
    for name, data in pulled.items():
        if name in _HOST_MEMBERS:
            layer, member = _HOST_MEMBERS[name]
            idx = lay.layer_index(layer)
            if idx >= 0:
                chunk.layers[idx][member] = data
        elif name == "cov":
            idx = lay.layer_index(layoutmod.COVARIANCE_LAYER)
            if idx >= 0:
                for j, m in enumerate(_COV_MEMBERS):
                    chunk.layers[idx][m] = data[:, j]
        elif name == "intensity":
            idx = lay.layer_index(layoutmod.INTENSITY_LAYER)
            if idx >= 0:
                chunk.layers[idx]["mean"] = data[:, 0]
                chunk.layers[idx]["cov"] = data[:, 1]
