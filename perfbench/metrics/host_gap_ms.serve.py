"""host_gap_ms.serve: the mean, over the steps dispatched before the traced
part of the window, of the host's time from a bucket's blocking read of
one step's outputs to its next dispatch (`ServeMetrics.host_gap`, on the
clock of the window's marks), in ms: the device has none of that bucket's
work meanwhile.  Nothing to read where the program keeps no such samples."""


def read(run):
    if run["kind"] != "serve" or "t" not in run["marks"]:
        return None
    samples = getattr(run["metrics"], "host_gap", None)
    if samples is None:
        return None
    gaps = [g for end, g in samples if end <= run["marks"]["t"]]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
