"""The train iteration's input preparation a train iteration (ms): the
program's `train_step.inputs` span in Trainer.train_iteration (keyframe
sampling, pyramid level, the cached camera and ground truth, the step
lookup)."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "train_step.inputs")
