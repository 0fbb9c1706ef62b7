"""The whole offline train iteration's share of the card's FP32 peak (%):
the counted operations of the traced iterations (port_bench/work.py: the
decoder MLPs on the anchors the prefilter kept, forward and backward; the
blend forward and backward of their binned views; the loss, forward and
backward, with the high-frequency terms only where the configuration's
frequency regularisation is on) over the traced window's time an iteration
at 67 TFLOP/s."""

from port_bench import work


def read(ctx):
    views = [v for v in ctx["views"] if v["kind"] == "f32"]
    if not views or not ctx["visible"] or not ctx["units"]:
        return None
    cam, opt = ctx["config"]["camera"], ctx["config"]["optimization"]
    mlp = 3 * sum(work.decoder_ops(ctx["config"]["model"], v)
                  for v in ctx["visible"]) / len(ctx["visible"])
    blend = sum(sum(w[1] for w in work.train_blend_work(
        v["start"], v["nk"], v["npix"], v["pairs"], v["n"])) for v in views) \
        / len(views)
    scales = 0
    if opt["use_frequency_regularization"]:
        scales = opt["scale_num"] if opt["use_multi_resolution"] else 1
    loss = 3 * work.loss_ops(cam["width"], cam["height"], scales)
    per_iter = ctx["trace"]["window_s"] / ctx["units"]
    return 100.0 * (mlp + blend + loss) / (per_iter * work.FP32_OPS_PER_S)
