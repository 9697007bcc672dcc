"""The closed loop: one client submits batch after batch through
``integrate_rays_async`` until ``seconds`` have passed (or a pool that does
not cycle is spent), then waits for the map (flush + synchronise)."""

from __future__ import annotations

import time


def drive_window(mapper, pool, seconds: float, sync, loop: dict) -> dict:
    from ohmbench.hostmeter import HostMeter

    if loop.get("clients", 1) != 1:
        raise ValueError(f"the closed loop runs one client, not {loop['clients']}")
    first = len(pool.sequence)
    rays, spent = 0, False
    host = HostMeter()
    t0 = host.t0
    now = t0
    while now - t0 < seconds:
        i = pool.take()
        if i is None:
            spent = True
            break
        mapper.integrate_rays_async(pool.batches[i])
        rays += pool.batches[i].shape[0] // 2
        now = time.perf_counter()
        host.tick(now)
    mapper.flush()
    sync()
    t1 = time.perf_counter()
    return {"start": t0, "end": t1, "seconds": t1 - t0, "rays": rays,
            "batches": pool.sequence[first:], "pool_spent": spent,
            "host_by_second": host.seconds()}
