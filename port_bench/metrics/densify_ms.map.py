"""One densification adjust's host span (ms an adjust): the program's
`train_step.densify` span around the anchor adjust, over its own calls in
the traced window (one, at the interval's end)."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "train_step.densify", per_call=True)
