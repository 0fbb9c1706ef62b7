"""Visible gaussians the training binning dropped beyond the static compact
capacity a train iteration: the program's `render.compact_dropped` counter,
max(visible - compact, 0) summed on the device over the traced window."""

from port_bench import program


def read(ctx):
    return program.count_per_unit(ctx, "render.compact_dropped")
