"""Reduction of one torch.profiler window to what the per-layer metrics and
the result's `breakdown` read: device busy time (the union of every device
operation's interval), kernel time by name, runtime launch events, and the
idle gaps between device operations labelled by the host span open at the
gap's start (the harness's `bench.*` spans and the program's `train_step.*`
ranges)."""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
SPAN_PREFIXES = ("bench.", "train_step.")


class Window:
    """A profiled window: enter, run the work, exit; `summary()` reduces."""

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._span = torch.profiler.record_function("bench.window")
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def events(self) -> list[tuple]:
        """(name, on the device, start us, end us, user annotation) of every
        event of the window, read from the profiler's raw results (its
        FunctionEvent tree takes minutes to build for a few hundred
        thousand launches)."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            out.append((e.name(), e.device_type() != DeviceType.CPU, start,
                        start + e.duration_ns() / 1e3,
                        e.is_user_annotation()))
        return out

    def summary(self) -> dict:
        t_read = time.perf_counter()
        events = self.events()
        cpu = [e for e in events if not e[1]]
        win = [e for e in cpu if e[0] == "bench.window"]
        w0 = win[0][2] if win else min(e[2] for e in cpu)
        w1 = win[0][3] if win else max(e[3] for e in cpu)
        dev = [e for e in events if e[1] and not e[4]
               and not e[0].startswith(SPAN_PREFIXES)]
        intervals = sorted((max(e[2], w0), min(e[3], w1)) for e in dev
                           if e[3] > w0 and e[2] < w1)
        merged = []
        for a, b in intervals:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_us = sum(b - a for a, b in merged)
        by_name: dict[str, float] = {}
        count_by_name: dict[str, int] = {}
        for name, _, a, b, _ in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            count_by_name[name] = count_by_name.get(name, 0) + 1
        launches = sum(1 for e in cpu if e[0] in LAUNCH_EVENTS
                       and w0 <= e[2] <= w1)
        # idle gaps, by the innermost host span open at the gap's start
        spans = sorted(((e[2], e[3], e[0]) for e in cpu
                        if e[0].startswith(SPAN_PREFIXES)
                        and e[0] != "bench.window"))
        starts = [s[0] for s in spans]
        gaps: dict[str, float] = {}
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            label = "outside every span"
            i = bisect.bisect_right(starts, a) - 1
            best = None
            while i >= 0:
                s, e_, name = spans[i]
                if s <= a < e_ and (best is None or s > best[0]):
                    best = (s, name)
                if a - s > 5e6:  # spans longer than 5 s do not occur
                    break
                i -= 1
            if best is not None:
                label = best[1]
            gaps[label] = gaps.get(label, 0.0) + (b - a)
        return {
            "window_s": (w1 - w0) / 1e6,
            "busy_s": busy_us / 1e6,
            "device_events": len(dev),
            "kernels": sum(1 for e in dev if "memcpy" not in e[0].lower()
                           and "memset" not in e[0].lower()),
            "launches": launches,
            "device_by_name": {k: v / 1e6 for k, v in by_name.items()},
            "count_by_name": count_by_name,
            "idle_by_span": {k: v / 1e6 for k, v in gaps.items()},
            "read_s": time.perf_counter() - t_read,
        }


def kernel_seconds(summary: dict, names) -> tuple[float, int]:
    """(device seconds, kernel records) of the kernels whose name contains
    one of `names`."""
    total, n = 0.0, 0
    for k, v in summary["device_by_name"].items():
        if any(name in k for name in names):
            total += v
            n += summary["count_by_name"][k]
    return total, n


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def spans(on: bool):
    """record_function when tracing, else a context that records nothing."""
    if on:
        return torch.profiler.record_function
    return lambda name: contextlib.nullcontext()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()
