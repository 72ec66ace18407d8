"""Device ms a call of the predictor's snap and clustering: `snap`,
`px_to_world`, `ops/cluster.cluster_gaussian_fit` and the outputs'
transposes, the span `predict.cluster`'s device time over its count.

It reads the program's span registry (`dyobav_tpu_torch.utils.profiling.
summary()`), which fills while the cell's traced calls run under the
profiler; a span's device time runs from a CUDA event recorded on the
stream as the stage starts to one as it ends.  None outside a traced run
of the predictor, and where the program has no such span or the span saw
no CUDA device."""
SPAN = "predict.cluster"


def read(obs):
    if "predict" not in obs.get("traces", {}):
        return None
    try:
        from dyobav_tpu_torch.utils import profiling
    except ImportError:            # a program without spans
        return None
    s = profiling.summary().get(SPAN)
    if not s or not s["count"] or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / s["count"]
