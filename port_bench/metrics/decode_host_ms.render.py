"""The eval render's anchor prefilter and neural-gaussian decode a view
(ms): the program's `render.prefilter` and `render.decode` spans in
neural_gaussians_for_view, summed."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "render.prefilter", "render.decode")
