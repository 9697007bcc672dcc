"""Captured CUDA graphs of the worker's device work.

Once a mapper's shape caches are primed (``prime_caps``) and its auto-sized
windows read back (``scatter_cap``, ``row_cap``, NDT's ``miss_k``), a
rayflow group's device work -- decode, K1, the key sort, the apply (K2), or
NDT's miss and hit phases (the fused flag gather, the scans, K3), and the
stats -- is the same sequence of kernels on the same shapes batch after
batch, and reads nothing back.  Issued from Python it costs hundreds of
launches a batch; captured once into a CUDA graph it is one launch.

``GraphCache`` keeps such graphs by key (the mapper builds the key from
everything the captured launches depend on: ``TorchRayMapper._graph_key``),
at most ``capacity``, the least recently used out.  A key's first sighting
runs eagerly, its second captures and replays, later ones replay; a key
whose capture raised stays eager for the cache's life.  A capture runs the
body under ``Profile.forbid_syncs``, so a path that reads the device back
(a ``Profile.sync`` scope) stops the capture before it reaches the device.
Every graph is made under an epoch (the mapper's sized windows and arena
addresses, ``TorchRayMapper._graph_epoch``); the windows only grow and a
freed arena does not return, so a new epoch drops every graph, and the
private memory pool each holds, at once.

The hand-written kernels' wrappers count their launches as Python calls
them (``.launches``).  A capture calls them but launches nothing, and a
replay launches them without a call: a graph keeps what its capture
counted, adds it back at each replay, and a capture that raises takes its
counts back.

Counters (the process-wide ``Profile``'s while it records, and the cache's
own attributes always): ``graph_replays`` (batches integrated by a replay),
``graph_captures``, ``graph_fallbacks`` (captures that raised); a capture
is a ``worker.capture`` span, a replay a ``graph.replay`` span.
"""

from __future__ import annotations

import collections
import dataclasses
import logging

import torch

from ohm_tpu_torch.ops import deposit_cuda, expand_cuda, gather_cuda, slotgrid_cuda, tsdf_cuda
from ohm_tpu_torch.utils.profile import Profile

_PROFILE = Profile.instance()

#: The kernel wrappers that count their launches (``.launches``).
_COUNTED = tuple(dict.fromkeys(
    fn for mod in (deposit_cuda, expand_cuda, gather_cuda, slotgrid_cuda, tsdf_cuda)
    for fn in vars(mod).values() if callable(fn) and hasattr(fn, "launches")))


def _launch_counts() -> list[int]:
    return [fn.launches for fn in _COUNTED]


def _add_launches(counts) -> None:
    """Add ``counts`` ((wrapper, launches) pairs) to the wrappers' counts."""
    for fn, n in counts:
        fn.launches += n


#: What ``GraphCache.step`` says to do with a key.
EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"


@dataclasses.dataclass
class Graph:
    """One captured group: the graph, the static input its uploads copy
    into, the static stats it writes (int64, one row a stats entry), and
    the route the mapper's host logic took while it was captured, and the
    kernel launches a replay makes ((wrapper, launches) pairs)."""
    graph: object
    input: torch.Tensor
    stats: torch.Tensor
    route: str | None = None
    launches: tuple = ()


class CudaCapture:
    """Captures a body's launches into a ``torch.cuda.CUDAGraph`` on a side
    stream of ``device`` (a capture cannot run on the default stream), in
    the thread-local error mode: only the capturing thread's unsafe calls
    break it, not the client thread's.  Returns (graph, the body's
    result); nothing of the body runs until the graph is replayed."""

    def __init__(self, device):
        self.device = device
        self._stream = None

    def __call__(self, body):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = body()
                finally:
                    graph.capture_end()
        except BaseException:
            self._stream = None  # the next capture starts on another stream
            raise
        current.wait_stream(self._stream)
        return graph, out


def _remember(keys: collections.OrderedDict, key, limit: int) -> None:
    """Add ``key`` to ``keys``, dropping the oldest past ``limit``."""
    keys[key] = True
    if len(keys) > limit:
        keys.popitem(last=False)


class GraphCache:
    """Captured graphs by key, at most ``capacity``, least recently used
    out; ``capture`` is ``CudaCapture`` or a stand-in with its call."""

    #: Graphs kept (an escalation or an arena reallocation changes the key,
    #: and the stale graph ages out).
    capacity = 8
    #: Keys sighted once, and keys whose capture raised, remembered at most
    #: (one-off keys cost no capture; a failed key is not tried again).
    remember = 64

    def __init__(self, capture):
        self._capture = capture
        self._graphs = collections.OrderedDict()
        self._seen = collections.OrderedDict()  # keys sighted once
        self._eager = collections.OrderedDict()  # keys whose capture raised
        self._epoch = None  # what the graphs and the keys seen were made under
        self.replays = 0  # batches integrated by a replay
        self.captures = 0
        self.fallbacks = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def step(self, key, epoch=None) -> tuple:
        """(EAGER, None) for a key first sighted now or whose capture
        raised, (CAPTURE, None) at its second sighting, else (REPLAY, its
        Graph).  An ``epoch`` other than the last drops every graph and
        every key seen once."""
        if epoch != self._epoch:
            self._graphs.clear()
            self._seen.clear()
            self._epoch = epoch
        if key in self._eager:
            self._eager.move_to_end(key)
            return EAGER, None
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            return REPLAY, entry
        if self._seen.pop(key, None) is not None:
            return CAPTURE, None
        _remember(self._seen, key, self.remember)
        return EAGER, None

    def capture(self, key, static_input: torch.Tensor, body, count: int = 1) -> Graph | None:
        """Capture ``body`` (the device work of ``count`` batches reading
        ``static_input``; it returns the static stats) under ``key``, or
        None where the capture raised: the key then stays eager.  The
        launches the body counted are taken back; the graph adds them at
        each replay."""
        before = _launch_counts()
        try:
            with _PROFILE.span("worker.capture", count=count, counter="graph_captures"), \
                    _PROFILE.forbid_syncs():
                graph, stats = self._capture(body)
        except Exception:  # the group runs eagerly instead
            graph = None
            logging.getLogger("ohm_tpu_torch").debug("graph capture fell back to eager",
                                                     exc_info=True)
        counted = tuple((fn, n - b) for fn, n, b in zip(_COUNTED, _launch_counts(), before)
                        if n != b)
        _add_launches((fn, -n) for fn, n in counted)
        if graph is None:
            _remember(self._eager, key, self.remember)
            self.fallbacks += 1
            _PROFILE.count("graph_fallbacks")
            return None
        self.captures += 1
        entry = self._graphs[key] = Graph(graph, static_input, stats, launches=counted)
        while len(self._graphs) > self.capacity:
            self._graphs.popitem(last=False)
        return entry

    def replay(self, entry: Graph, count: int = 1) -> torch.Tensor:
        """Replay ``entry`` for ``count`` batches; returns a copy of its
        stats, which the next replay overwrites."""
        with _PROFILE.span("graph.replay", count=count, counter="graph_replays"):
            entry.graph.replay()
        _add_launches(entry.launches)
        self.replays += count
        return entry.stats.clone()
