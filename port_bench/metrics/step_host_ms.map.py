"""The mean host span of one Trainer.train_iteration in the traced window
(ms): the step and its densification, from its call to its return."""


def read(ctx):
    if not ctx["spans"]:
        return None
    return 1e3 * sum(ctx["spans"]) / len(ctx["spans"])
