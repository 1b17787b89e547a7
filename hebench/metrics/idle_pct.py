"""idle_pct.<x>: the share of the traced stretch in which no device
activity ran (the union of the kernel and copy intervals), in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device_ops or not tr.window_us:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
