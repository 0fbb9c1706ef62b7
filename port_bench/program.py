"""What the program's own spans and counters recorded (the port's
`segs_slam_tpu_torch.utils.tracing` registry), for the per-layer metrics
that read them. The registry records only while a profiler session runs,
and the traced window is the benchmark process's only session, so it holds
that window's units. A program without the registry, or a window in which a
span or counter never fired, reads None."""

from __future__ import annotations


def registry() -> dict | None:
    """The program's spans and counts, or None where it has no registry."""
    try:
        from segs_slam_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.read()


def span_ms(ctx, *names: str, per_call: bool = False) -> float | None:
    """The host milliseconds of the spans `names`, summed, a unit of the
    window (per_call: a call of the first of them)."""
    reg = registry()
    if reg is None or not ctx["units"]:
        return None
    found = [reg["spans"][n] for n in names if n in reg["spans"]]
    if not found:
        return None
    seconds = sum(s["s"] for s in found)
    per = found[0]["calls"] if per_call else ctx["units"]
    return 1e3 * seconds / per


def count_per_unit(ctx, name: str) -> float | None:
    """Counter `name` over the window's units."""
    reg = registry()
    if reg is None or not ctx["units"] or name not in reg["counts"]:
        return None
    return reg["counts"][name] / ctx["units"]
