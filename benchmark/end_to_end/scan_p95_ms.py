"""The 95th percentile, in ms, of the window's per-scan latencies: each from
before the scan is offered to after the card has finished it (host clock),
over every scan of the window's whole passes; numpy's linear interpolation
between the closest ranks.  None where the traffic times no single scan."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat, np.float64), 95))
