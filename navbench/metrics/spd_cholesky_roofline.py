"""Share (%) of its roofline that the SPD kernel (`csrc/spd_cholesky.cu`)
reaches over one escalated solve: the least time of each call at its shape
(`yardstick/spd_bound`, bytes at 3.35 TB/s or operations at 67 TFLOP/s)
summed over the calls, over their summed device time.  The warm stage's
calls (counted in its own trace) are at (B, 4) systems, the rest at the
escalation's (K, 4)."""
from navbench.harness import peaks
from navbench.yardstick.spd_bound import spd_bound_s


def read(obs):
    traces = obs.get("traces", {})
    if "escalated" not in traces or "warm" not in traces:
        return None
    calls = [d for v in traces["escalated"]["kernel_calls"].values()
             for d in v]
    n_warm = sum(len(v) for v in traces["warm"]["kernel_calls"].values())
    if not calls or n_warm > len(calls):
        return None
    w, pk = obs["work"], peaks()
    bound = (n_warm * spd_bound_s(4 * w["lanes"], w["n"], pk)
             + (len(calls) - n_warm) * spd_bound_s(4 * w["slots"], w["n"], pk))
    return 100.0 * bound / sum(calls)
