"""Spans and counters of the port's layers, recorded only while a torch
profiler session records.

`span(name)` names a region of host work. With a session on
(`torch.profiler.profile`, `torch.autograd.profiler.emit_nvtx`, anything
that starts the autograd profiler) it is a `record_function` range, on the
profiler's clock with the device events, and its host duration is added to
the registry: calls and seconds by name. With none, it is one shared no-op
context, and the call costs one attribute read.

`count(name, value)` adds a host number or a 0-d device tensor to the
registry, only while a session records. Device values are kept by reference
and summed on the device in batches of `_FOLD`, so the caller never waits
for the device and the registry's memory stays bounded. `peak(name, value)`
keeps the largest host number given.

`read()` returns {"spans": {name: {"calls", "s"}}, "counts": {name:
number}} (it waits for the device sums); `reset()` empties the registry.
Updates take a lock: CUDA autograd runs the backward on its own thread, and
the live viewer renders from another.

Every span and counter, and the metric or operator use each is for, is
listed in PERF.md.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

# device values held by reference before one sum on the device folds them
_FOLD = 64

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a torch profiler session is recording (the flag that
    torch.profiler.profile and emit_nvtx set)."""
    return _profiler._is_profiler_enabled


class Registry:
    """Span calls and seconds, host counts, peaks and the device sums of the
    counts given as tensors, by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._clear()

    def _clear(self):
        self._spans: dict[str, list] = {}  # name -> [calls, seconds]
        self._host: dict[str, float] = {}
        self._peaks: dict[str, float] = {}
        self._pending: dict[str, list[torch.Tensor]] = {}
        self._device: dict[str, torch.Tensor] = {}  # folded float64 sums

    def reset(self) -> None:
        with self._lock:
            self._clear()

    def add_span(self, name: str, seconds: float) -> None:
        with self._lock:
            s = self._spans.get(name)
            if s is None:
                self._spans[name] = [1, seconds]
            else:
                s[0] += 1
                s[1] += seconds

    def count(self, name: str, value) -> None:
        with self._lock:
            if isinstance(value, torch.Tensor):
                pending = self._pending.setdefault(name, [])
                pending.append(value.detach())
                if len(pending) >= _FOLD:
                    self._fold(name)
            else:
                self._host[name] = self._host.get(name, 0) + value

    def peak(self, name: str, value) -> None:
        with self._lock:
            if name not in self._peaks or value > self._peaks[name]:
                self._peaks[name] = value

    def _fold(self, name: str) -> None:
        """The pending device values of `name` summed into its device total
        (lock held); launches work, never waits for it."""
        pending = self._pending.pop(name, [])
        if not pending:
            return
        total = torch.stack([t.reshape(()) for t in pending]).double().sum()
        prev = self._device.get(name)
        self._device[name] = total if prev is None else prev + total

    def read(self) -> dict:
        with self._lock:
            for name in list(self._pending):
                self._fold(name)
            counts = dict(self._host)
            for name, total in self._device.items():
                counts[name] = counts.get(name, 0) + total.item()
            counts.update(self._peaks)
            return {"spans": {k: {"calls": c, "s": s}
                              for k, (c, s) in self._spans.items()},
                    "counts": counts}


_REGISTRY = Registry()


class _Span:
    """A record_function range that also adds its host duration to the
    registry."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        _REGISTRY.add_span(self.name, dt)
        return False


def span(name: str):
    """A context naming a region of host work; see the module docstring."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, value) -> None:
    """Adds `value` (a host number or a 0-d tensor) to counter `name` while
    a profiler session records."""
    if _profiler._is_profiler_enabled:
        _REGISTRY.count(name, value)


def peak(name: str, value) -> None:
    """Keeps the largest host number given for `name` while a profiler
    session records."""
    if _profiler._is_profiler_enabled:
        _REGISTRY.peak(name, value)


def read() -> dict:
    """{"spans": {name: {"calls", "s"}}, "counts": {name: number}}."""
    return _REGISTRY.read()


def reset() -> None:
    _REGISTRY.reset()
