"""ntt_roofline_pct: the NTT work of the traced sorts' ops at its least time on the H100 (`sol.py`), over the NTT kernels' device time in the trace."""

from portbench import sol


def read(run):
    ntt_s = run.trace.get("ntt_s", 0.0)
    planes = sol.tally_planes(run.params, run.tally)
    if ntt_s <= 0 or planes <= 0:
        return None
    return 100.0 * sol.ntt_seconds(planes, run.params["ring_n"]) / ntt_s
