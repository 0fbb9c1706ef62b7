"""Tile-gaussian pairs a binned view: the program's `render.pairs` counter
(the exact binning's instances, summed on the device) over the traced
window's iterations, one training view each."""

from port_bench import program


def read(ctx):
    return program.count_per_unit(ctx, "render.pairs")
