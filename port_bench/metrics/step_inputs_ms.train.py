"""The train iteration's input preparation a train iteration (ms): the
program's `train_step.inputs` span in Trainer.train_iteration, in the
offline trainer's cells (`step_inputs_ms.map`'s reading, kept apart
because that metric lists the mapper's cells)."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "train_step.inputs")
