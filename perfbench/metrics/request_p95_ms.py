"""request_p95_ms: the 95th percentile (linear interpolation), over every
request sent in the window (those drained after its close included), of
the time from the client's submission to its forces on the host; a failed
request counts as missing every limit (an infinite time)."""
import numpy as np


def read(run):
    if run["kind"] != "serve" or not run["records"]:
        return None
    lat = np.asarray([np.inf if r["failed"] else r["t_done"] - r["t_sub"]
                      for r in run["records"]])
    return float(np.percentile(lat, 95)) * 1e3
