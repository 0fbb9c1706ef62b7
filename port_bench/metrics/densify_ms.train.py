"""One densification adjust's host span (ms an adjust): the program's
`train_step.densify` span over its own calls in the traced window (one, at
the interval's end), in the offline trainer's cells (`densify_ms.map`'s
reading, kept apart because that metric lists the mapper's cells)."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "train_step.densify", per_call=True)
