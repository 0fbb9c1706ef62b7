"""Train iterations that Mapper.run completed in the window over the
window's seconds, which end after a torch.cuda.synchronize() (iters/s)."""


def read(ctx):
    if not ctx["units"]:
        return None
    return ctx["units"] / ctx["window_s"]
