"""Visible gaussians the training binning dropped a train iteration: the
program's `render.compact_dropped` counter over the traced window, in the
offline trainer's cells, where the exact binning drops none and counts 0
(`compact_dropped.map`'s reading, kept apart because that metric lists the
mapper's cells)."""

from port_bench import program


def read(ctx):
    return program.count_per_unit(ctx, "render.compact_dropped")
