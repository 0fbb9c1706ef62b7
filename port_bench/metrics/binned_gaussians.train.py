"""Alive visible gaussians entering the binning a view: the program's
`render.binned_gaussians` counter (the exact binning keeps every one) over
the traced window's iterations, one training view each."""

from port_bench import program


def read(ctx):
    return program.count_per_unit(ctx, "render.binned_gaussians")
