"""One mapping operation's handling on the mapper's host (ms an
operation): the program's `mapper.apply_op` span in Mapper.run (the
keyframe added, its points inserted and cached; the map's initialisation
at the first keyframes), over its own calls in the traced window."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "mapper.apply_op", per_call=True)
