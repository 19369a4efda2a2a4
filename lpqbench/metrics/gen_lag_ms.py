"""95th percentile of how late the generator sent a request (send time
minus due time), in ms: whether the generator, not the program, set the
tail.  Open loops only."""

import numpy as np


def read(ctx):
    lags = [r["send_lag_s"] for r in ctx["window"]["requests"]
            if "send_lag_s" in r]
    return float(np.percentile(lags, 95) * 1e3) if lags else None
