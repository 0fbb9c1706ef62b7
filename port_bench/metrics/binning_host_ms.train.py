"""The training binning's host span a train iteration (ms): the program's
`render.binning` span inside the training blend's forward (the exact
binning: count, scan, emit, sort, tile ranges), in the offline trainer's
cells (`binning_host_ms.map`'s reading, kept apart because that metric
lists the mapper's cells)."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "render.binning")
