"""bfv_basis_roofline.<x>: the least time of the request's BFV
double-basis conversions (the calls its work marks as `double_basis`:
the Q -> QMul and QMul -> Q mod_ups and the quantize's ModDown by QMul,
each operand's words read once and the result written once at 4 bytes,
as work.py counts them) over the traced time of the kernels that
kernel_maps list under "bfv_basis", per request, in %. None where the
request converts no basis or the trace holds no such kernel."""

import dataclasses


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    marked = getattr(w, "double_basis", None)
    spent = tr.time_of(ctx["kernel_maps"].get("bfv_basis", ()))
    if not marked or not spent:
        return None
    least = w.seconds(dataclasses.replace(w, calls=list(marked)).ks_coeffs())
    return 100.0 * least * tr.requests / spent
