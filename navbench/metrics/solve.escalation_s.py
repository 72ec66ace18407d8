"""Host seconds of the escalation ladder (`ops/engine.escalate_tail`): one
escalated solve's wall time less its warm stage's, on the same problems."""


def read(obs):
    spans = obs.get("spans", {})
    if "escalated_s" not in spans or "warm_stage_s" not in spans:
        return None
    return spans["escalated_s"] - spans["warm_stage_s"]
