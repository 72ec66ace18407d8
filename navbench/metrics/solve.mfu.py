"""Share (%) of the card's float32 peak (67 TFLOP/s) that one escalated
solve reaches: the operations of the SPD systems its configuration must
solve (`yardstick/newton_work`), over its host wall time.  A floor on the
step's work: the Hessians and merits are not counted."""
from navbench.harness import peaks


def read(obs):
    spans, work = obs.get("spans", {}), obs.get("work", {})
    if "escalated_s" not in spans or "solve_flops" not in work:
        return None
    return (100.0 * work["solve_flops"] / spans["escalated_s"]
            / peaks()["fp32_flops_per_s"])
