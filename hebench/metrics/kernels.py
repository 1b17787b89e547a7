"""kernels.<x>: kernels launched per request in the traced stretch (copies
and fills left out): the dispatch work the host pays for."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.kernels:
        return None
    return len(tr.kernels) / tr.requests
