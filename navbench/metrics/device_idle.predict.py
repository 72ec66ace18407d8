"""Share (%) of the traced wall time of a few predictor calls in which no
operation ran on the device (events merged, so overlaps count once)."""
from navbench.yardstick.profiler import idle_percent


def read(obs):
    return idle_percent(obs.get("traces", {}).get("predict"))
