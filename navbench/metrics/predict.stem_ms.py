"""Device ms a call of the net's factored stem: the stem convolution of the
shared channels, that of the all-ones offset channel and
`ops/stem.stem_expand_pool` (offsets, BatchNorm, LeakyReLU, max pool),
the span `predict.stem`'s device time over its count.

It reads the program's span registry (`dyobav_tpu_torch.utils.profiling.
summary()`), which fills while the cell's traced calls run under the
profiler; a span's device time runs from a CUDA event recorded on the
stream as the stage starts to one as it ends.  None outside a traced run
of the predictor, and where the program has no such span (a program whose
stem is not factored) or the span saw no CUDA device."""
SPAN = "predict.stem"


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
