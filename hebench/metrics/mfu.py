"""mfu.<x>: the whole request's share of the chip's peak: the least time of
its essential bytes (work.py's reads: every ciphertext, key, CRS and
plaintext it must touch, read once, and its output, at 4 bytes a
coefficient) at the HBM rate, over the measured time per request of the
untraced window, in %. HE work is integer and bandwidth-bound, so the
peak is the HBM roofline."""


def read(ctx):
    w = ctx["work"]
    least = w.seconds(sum(w.reads.values()))
    return 100.0 * least / (ctx["window_s"] / ctx["requests"])
