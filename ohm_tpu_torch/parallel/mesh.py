"""ShardMesh: one process driving one device per shard.

The counterpart of what ``ohm_tpu/parallel/`` takes from JAX: a
``jax.sharding.Mesh`` over ``jax.devices()``, ``jax.shard_map`` running each
shard's unchanged single-chip core, and ``jax.lax.all_to_all`` inside the
same program.  The JAX package is single-controller (one process drives
every chip), and so is this: a ``ShardMesh`` holds one ``torch.device`` per
shard, ``run`` calls a function once per shard on that shard's device, and
``all_to_all`` swaps per-destination blocks between shards.  A device may
repeat: ``ShardMesh.repeat("cuda", 4)`` puts four shards on one card, as the
JAX tests put eight shards on one CPU.  No ``torch.distributed`` process
group is involved (NCCL refuses two ranks on one GPU, and the JAX package
has no multi-process mode).
"""

from __future__ import annotations

import contextlib

import torch

from ohm_tpu_torch.device import resolve_device


class ShardMesh:
    """One torch.device per shard, in shard order."""

    def __init__(self, devices):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a ShardMesh needs at least one device")

    @classmethod
    def repeat(cls, device="cuda", n: int = 1) -> "ShardMesh":
        """``n`` shards on one device."""
        return cls([device] * int(n))

    @classmethod
    def over_cards(cls, n: int, device="cuda") -> "ShardMesh":
        """``n`` shards, one a card where CUDA shows ``n`` cards, else all on
        ``device`` (the CPU, or the first card)."""
        dev = resolve_device(device)
        if dev.type == "cuda" and torch.cuda.device_count() >= n:
            return cls([torch.device("cuda", i) for i in range(n)])
        return cls.repeat(dev, n)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def run(self, fn, per_shard_args) -> list:
        """``[fn(s, *per_shard_args[s]) for each shard s]``, each call with
        shard s's device current (its CUDA launches go to that device's
        current stream)."""
        out = []
        for s, args in enumerate(per_shard_args):
            dev = self.devices[s]
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                out.append(fn(s, *args))
        return out

    def all_to_all(self, send: list) -> list:
        """Swap blocks between shards: ``send[s]`` [n_dest, cap, ...] on shard
        s's device -> ``recv[d]`` [n_src, cap, ...] on shard d's device, with
        ``recv[d][s] = send[s][d]`` (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
        if len(send) != self.n_shards:
            raise ValueError(f"{len(send)} send blocks for {self.n_shards} shards")
        if all(d == self.devices[0] for d in self.devices):
            stacked = torch.stack(send)  # [src, dest, cap, ...]
            return list(stacked.transpose(0, 1).contiguous().unbind(0))
        return [torch.stack([blk[d].to(dev, non_blocking=True) for blk in send])
                for d, dev in enumerate(self.devices)]

    def gather_stats(self, stats: list, names) -> dict:
        """Per-shard stats dicts of 0-dim tensors -> {name: tensor
        [n_shards]} on shard 0's device (the JAX step's stats, sharded on
        the leading axis)."""
        dev = self.devices[0]
        return {k: torch.stack([st[k].to(dev, non_blocking=True) for st in stats])
                for k in names}
