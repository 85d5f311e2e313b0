"""ntt_device_pct: the NTT kernels' share of the device operations' time in the traced window."""


def read(run):
    op_s = run.trace.get("op_s", 0.0)
    ntt_s = run.trace.get("ntt_s", 0.0)
    return 100.0 * ntt_s / op_s if op_s > 0 and ntt_s > 0 else None
