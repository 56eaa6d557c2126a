"""95th percentile over every request due in the window of its completion
(words on the host) less its due time, in ms (host clock). A request that
never came counts as beyond any limit."""
from benchmark.record import percentile

NEVER_MS = 1e12


def read(run):
    lat = [NEVER_MS if it.failed else (it.done - it.due) * 1e3
           for it in run.items]
    return percentile(lat, 95)
