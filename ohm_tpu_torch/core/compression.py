"""Background chunk compression with memory watermarks.

Reference parity: ohm/VoxelBlock.{h,cpp} (transparent zlib-compressed voxel
blocks with retain/release) and ohm/VoxelBlockCompressionQueue.{h,cpp}
(background thread; high/low memory "tides" trigger LRU compression).

Host chunks here are numpy arrays; compression swaps a chunk's layer arrays
for zlib blobs when the uncompressed footprint exceeds the high tide,
decompressing transparently on access via OccupancyMap hooks
(``CompressedChunkStore.access`` / the mapper's region() path).
"""

from __future__ import annotations

import threading
import time
import zlib

import numpy as np


class CompressedChunkStore:
    """Manages compressed state for a map's chunks."""

    def __init__(self, map_obj, high_tide_bytes: int = 512 << 20, low_tide_bytes: int = 256 << 20,
                 compression_level: int = 1):
        self.map = map_obj
        self.high_tide = high_tide_bytes
        self.low_tide = low_tide_bytes
        self.level = compression_level
        #: region key -> list of (dtype, nbytes, blob) per layer
        self._compressed: dict = {}
        self._last_access: dict = {}
        self._counter = 0
        self._lock = threading.Lock()
        self._thread = None
        self._quit = threading.Event()

    # ------------------------------------------------------------------ #

    def set_high_tide(self, nbytes: int):
        self.high_tide = nbytes

    def set_low_tide(self, nbytes: int):
        self.low_tide = nbytes

    def uncompressed_bytes(self) -> int:
        total = 0
        for key, chunk in self.map.chunks.items():
            if key in self._compressed:
                continue
            total += sum(arr.nbytes for arr in chunk.layers)
        return total

    def compressed_count(self) -> int:
        return len(self._compressed)

    # ------------------------------------------------------------------ #

    def access(self, region_key):
        """Touch a chunk, decompressing if needed. Returns the chunk."""
        key = tuple(int(v) for v in np.asarray(region_key).reshape(3))
        with self._lock:
            self._counter += 1
            self._last_access[key] = self._counter
            if key in self._compressed:
                self._decompress(key)
        return self.map.chunks.get(key)

    def _compress(self, key):
        chunk = self.map.chunks.get(key)
        if chunk is None or key in self._compressed:
            return 0
        blobs = []
        freed = 0
        for arr in chunk.layers:
            blobs.append((arr.dtype, arr.nbytes, zlib.compress(arr.tobytes(), self.level)))
            freed += arr.nbytes
        self._compressed[key] = blobs
        chunk.layers = []  # release the arrays
        return freed

    def _decompress(self, key):
        chunk = self.map.chunks.get(key)
        blobs = self._compressed.pop(key, None)
        if chunk is None or blobs is None:
            return
        chunk.layers = [np.frombuffer(zlib.decompress(blob), dtype=dtype).copy()
                        for dtype, _n, blob in blobs]

    # ------------------------------------------------------------------ #

    def run_once(self) -> int:
        """One compression pass: if above high tide, compress LRU chunks down
        to the low tide (reference: VoxelBlockCompressionQueue tides)."""
        with self._lock:
            usage = self.uncompressed_bytes()
            if usage <= self.high_tide:
                return 0
            candidates = sorted(
                (k for k in self.map.chunks if k not in self._compressed),
                key=lambda k: self._last_access.get(k, 0))
            freed_total = 0
            for key in candidates:
                freed_total += self._compress(key)
                if usage - freed_total <= self.low_tide:
                    break
            return freed_total

    def start_thread(self, interval: float = 0.5):
        if self._thread is not None:
            return
        self._quit.clear()

        def loop():
            while not self._quit.wait(interval):
                self.run_once()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop_thread(self):
        if self._thread is None:
            return
        self._quit.set()
        self._thread.join()
        self._thread = None

    def decompress_all(self):
        with self._lock:
            for key in list(self._compressed):
                self._decompress(key)
