"""The 95th percentile of every view's time in the window, from the call
to the image on the host (ms)."""

import numpy as np


def read(ctx):
    if not ctx["times"]:
        return None
    return 1e3 * float(np.percentile(ctx["times"], 95))
