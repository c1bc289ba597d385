"""kernel_roofline.<op> (kernels, device trace), in %: the least time the
card could take for the traced calls, over the profiler's time of every
kernel in the traced window. The least time is (C + R) * N * B bytes per
call, each input byte read once and each output byte written once, at
the card's memory bandwidth in `peaks.json`: the same for whatever kernel
or formulation runs. No number where the card is not in the table or no
kernel ran."""


def read(rec):
    t, peak = rec["trace"], rec["peak"]
    if not t or not peak or t["kernel_s"] <= 0:
        return None
    least_s = t["min_bytes"] / peak["hbm_bytes_per_s"]
    return 100.0 * least_s / t["kernel_s"]
