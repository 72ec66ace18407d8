"""Device kernels a training step launches, from the device trace of a few
chunks (each kernel on the device is one launch)."""


def read(obs):
    tr = obs.get("traces", {}).get("train")
    steps = obs.get("work", {}).get("traced_steps")
    if tr is None or not steps:
        return None
    return tr["kernel_events"] / steps
