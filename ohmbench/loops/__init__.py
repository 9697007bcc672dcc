"""How a traffic mix's clients drive the mapper in the measured window:
``ohmbench/loops/<kind>.py``, found by the mix's ``loop.kind``
(``ohmbench.find``).  A loop module gives ``drive_window(mapper, pool,
seconds, sync, loop)``: it submits the pool's batches (``pool.take()``)
for ``seconds`` as the mix's ``loop`` entry says, waits until the map
holds every one (``sync`` synchronises the card), and returns the window:
``start``, ``end``, ``seconds`` (host clock), ``rays`` submitted,
``batches`` (pool indices), ``pool_spent`` and ``host_by_second``."""
