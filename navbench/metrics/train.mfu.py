"""Share (%) of the card's float32 peak (67 TFLOP/s) that training steps
reach: three times the frozen reference net's forward operations (forward
and backward) times the samples of the steps, over their host wall time."""
from navbench.harness import peaks


def read(obs):
    w = obs.get("work", {})
    if not w.get("steps") or not w.get("steps_s"):
        return None
    return (100.0 * 3 * w["flops_per_image"] * w["batch"] * w["steps"]
            / w["steps_s"] / peaks()["fp32_flops_per_s"])
