"""The training blend forward's share of its roofline (%): the bound of
the traced iterations' own binned views (port_bench/work.py: the larger of
bytes over 3.35 TB/s and FP32 operations over 67 TFLOP/s) against the
device time of the kernels named below, per launch."""

from port_bench import trace, work

KERNELS = ("blend_fwd_kernel",)


def read(ctx):
    views = [v for v in ctx["views"] if v["kind"] == "f32"]
    seconds, records = trace.kernel_seconds(ctx["trace"], KERNELS)
    if not views or not records or seconds <= 0:
        return None
    bound = sum(work.bound_s(work.train_blend_work(
        v["start"], v["nk"], v["npix"], v["pairs"], v["n"])[0])
        for v in views) / len(views)
    return 100.0 * bound / (seconds / records)
