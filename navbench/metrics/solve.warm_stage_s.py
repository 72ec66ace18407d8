"""Host seconds of one warm stage (`bundle.solve_batch`, the fused Newton
loop over all lanes) on the window's next problems, ending in a device
synchronize."""


def read(obs):
    return obs.get("spans", {}).get("warm_stage_s")
