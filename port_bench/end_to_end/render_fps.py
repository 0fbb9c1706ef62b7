"""Views rendered in the window, each with its image copied to the host,
over the window's seconds (views/s): the reference's 1000 / mean render
time, taken over all the work of the window."""


def read(ctx):
    if not ctx["units"]:
        return None
    return ctx["units"] / ctx["window_s"]
