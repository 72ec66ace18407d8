"""Share (%) of the card's float32 peak (67 TFLOP/s) that the predictor's
calls reach: the frozen reference net's operations (`reference/swta_net.
flops_per_image`) times the images of the calls, over their host wall
time (each call ends in a device synchronize)."""
from navbench.harness import peaks


def read(obs):
    w = obs.get("work", {})
    if not w.get("calls") or not w.get("calls_s"):
        return None
    return (100.0 * w["flops_per_image"] * w["images_per_call"] * w["calls"]
            / w["calls_s"] / peaks()["fp32_flops_per_s"])
