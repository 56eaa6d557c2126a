"""95th percentile over the window's requests of the host's issue time less
the request's due time, in ms: how late the load generator ran."""
from benchmark.record import percentile


def read(run):
    return percentile([(it.issued - it.due) * 1e3 for it in run.items], 95)
