"""Device kernels of one escalated solve, from its device trace: each
kernel on the device is one launch."""


def read(obs):
    tr = obs.get("traces", {}).get("escalated")
    return None if tr is None else tr["kernel_events"]
