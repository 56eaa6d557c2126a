"""Mean host time of one call into the entry layer (``Image.from_array``
and ``compress``) in the window, in ms: the benchmark's spans around each
call (host clock)."""


def read(run):
    calls = [c.host_s for c in run.calls if not c.failed]
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
