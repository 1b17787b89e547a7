"""ks_roofline.<x>: the least time of the request's key-switching steps
(work.py: the digit mod_ups, the key contractions and the ModDowns, every
operand's distinct words read once and the result written once, at 4
bytes) over the traced time of the kernels that kernel_maps list under
"keyswitch", per request, in %. None where the request switches no key
or the trace holds no such kernel."""


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    least = w.seconds(w.ks_coeffs())
    spent = tr.time_of(ctx["kernel_maps"].get("keyswitch", ()))
    if not least or not spent:
        return None
    return 100.0 * least * tr.requests / spent
