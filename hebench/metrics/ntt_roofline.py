"""ntt_roofline.<x>: the least time of the request's limb-NTTs (work.py:
each transform's words read and written once at 4 bytes, one twiddle
table a limb and direction) over the traced time of the kernels that
kernel_maps list under "ntt", per request, in %. None where the trace
holds no such kernel."""


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    spent = tr.time_of(ctx["kernel_maps"].get("ntt", ()))
    if not spent:
        return None
    return 100.0 * w.seconds(w.ntt_coeffs()) * tr.requests / spent
