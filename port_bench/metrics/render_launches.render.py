"""Runtime kernel launches (cudaLaunchKernel and its kin, from the
profiler's trace) a rendered view over the traced window."""


def read(ctx):
    if not ctx["units"] or not ctx["trace"]["launches"]:
        return None
    return ctx["trace"]["launches"] / ctx["units"]
