"""The eval binning's host span a view (ms): the program's `render.binning`
span (the packed, direct-selection or f32 compaction, expansion and
sort)."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "render.binning")
