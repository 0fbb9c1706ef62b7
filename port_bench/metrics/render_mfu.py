"""The whole eval render's share of the card's FP32 peak (%): the counted
operations of the traced views (port_bench/work.py: the decoder MLPs on
the anchors the prefilter kept and the eval blend of their binned views)
over the traced window's time a view at 67 TFLOP/s."""

from port_bench import work


def read(ctx):
    views = ctx["views"]
    if not views or not ctx["visible"] or not ctx["units"]:
        return None
    mlp = sum(work.decoder_ops(ctx["config"]["model"], v)
              for v in ctx["visible"]) / len(ctx["visible"])
    blend = sum(work.eval_blend_work(v["start"], v["npix"], v["pairs"],
                                     v["n"])[1] for v in views) / len(views)
    per_view = ctx["trace"]["window_s"] / ctx["units"]
    return 100.0 * (mlp + blend) / (per_view * work.FP32_OPS_PER_S)
