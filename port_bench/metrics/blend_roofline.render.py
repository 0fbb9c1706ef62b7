"""The eval blend's share of its roofline (%): the eval work of the traced
views' own binned views (port_bench/work.py, the f32 row layout whichever
kernel runs) against the device time of the kernels named below, per
launch: K1 where the f32 binning feeds it, K3 on the packed columns."""

from port_bench import trace, work

KERNELS = ("blend_fwd_kernel", "blend_eval_kernel")


def read(ctx):
    views = ctx["views"]
    seconds, records = trace.kernel_seconds(ctx["trace"], KERNELS)
    if not views or not records or seconds <= 0:
        return None
    bound = sum(work.bound_s(work.eval_blend_work(
        v["start"], v["npix"], v["pairs"], v["n"])) for v in views) \
        / len(views)
    return 100.0 * bound / (seconds / records)
