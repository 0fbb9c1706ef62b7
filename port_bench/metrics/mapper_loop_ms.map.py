"""The mapper loop's own time a train iteration (ms): the traced window's
time an iteration less the mean host span of Trainer.train_iteration, which
the harness times by wrapping the method on the instance. What is left is
Mapper.run's queue wait, op handling and bookkeeping."""


def read(ctx):
    if not ctx["spans"] or not ctx["units"]:
        return None
    per_iter = ctx["trace"]["window_s"] / ctx["units"]
    return 1e3 * (per_iter - sum(ctx["spans"]) / len(ctx["spans"]))
