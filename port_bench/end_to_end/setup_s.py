"""The set-up time (s): from the start of the run to the start of the
window: the inputs, the program's state and caches, the compared steps or
the eval calibration, the warm-up, and in a checkout's first run the
port's nvcc builds."""


def read(ctx):
    return ctx["setup_s"]
