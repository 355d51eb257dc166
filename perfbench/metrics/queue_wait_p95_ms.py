"""queue_wait_p95_ms: the 95th percentile of the scheduler's queue wait
(submission to admission, `ServeMetrics.queue_wait_s`) of the requests
admitted before the traced part of the window."""
import numpy as np


def read(run):
    if run["kind"] != "serve":
        return None
    waits = run["metrics"].queue_wait_s[: run["marks"].get("n_wait")]
    return float(np.percentile(waits, 95)) * 1e3 if waits else None
