"""K4's share of its roofline in the offline stretch: the sum of its
calls' bounds (counts.k4_calls: shapes and active sites) over the int8
conv kernel's time in the profiler."""

UNIT = "%"


def read(ctx):
    t = ctx.trace
    if ctx.tag != "offline" or t is None or not t["k4_kernel_s"] \
            or not t["k4_bound_s"]:
        return None
    return 100.0 * t["k4_bound_s"] / t["k4_kernel_s"]
