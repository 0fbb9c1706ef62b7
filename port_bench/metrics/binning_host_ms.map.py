"""The training binning's host span a train iteration (ms): the program's
`render.binning` span (compaction, expansion and sort, f32 or packed)
inside the training blend's forward."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "render.binning")
