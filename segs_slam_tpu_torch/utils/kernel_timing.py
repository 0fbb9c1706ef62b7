"""Kernel times on the card, two ways.

`device_ms`: the mean device duration of one kernel, by name, from
torch.profiler's records of the kernels themselves over a run of launches:
the kernel alone, without the host work around its launch.
`event_ms`: CUDA events recorded around one call of a function (for a
kernel, its wrapper): the device's view of the call, with the host's input
checks, allocations and launch included, since the stream is empty when the
first event is recorded.
"""

from __future__ import annotations

import numpy as np
import torch


def device_ms(calls, kernel: str, reps: int = 20, warmup: int = 2) -> float:
    """Mean device duration (ms) of the kernels whose name contains
    `kernel`: the mean over `calls` (callables of no argument, each
    launching that kernel exactly once) of each one's mean over at least
    `reps` recorded launches, after `warmup` calls of each. The profiler
    loses some kernel records on the card (up to 30 % of a session's), so
    each call is profiled in sessions of `reps` launches until `reps`
    durations are in hand; raises after five sessions short of that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in calls:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    means = []
    for fn in calls:
        durations, names = [], set()
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    with record_function("kernel_timing.call"):
                        fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
            durations += [e.time_range.elapsed_us() for e in events
                          if kernel in e.name]
            names |= {e.name[:80] for e in events}
            if len(durations) >= reps:
                break
        else:
            raise RuntimeError(
                f"the profiler recorded {len(durations)} {kernel} kernels "
                f"for {5 * reps} launches; device events seen: "
                f"{sorted(names)}")
        means.append(float(np.mean(durations)) / 1e3)
    return float(np.mean(means))


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings of one fn() call, after
    warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def tile_counts(tile_start: torch.Tensor, tile_stop: torch.Tensor) -> dict:
    """Instances per tile of one binned view: mean, 99th percentile, max
    and the total."""
    n = (tile_stop - tile_start).double().cpu()
    return {"mean": float(n.mean()), "p99": float(torch.quantile(n, 0.99)),
            "max": int(n.max()), "total": int(n.sum())}
