"""The readers of the predictor's spans (`metrics/predict.*_ms.py`) on a
fake span registry: ms a call where a traced run of the predictor filled
it, None elsewhere and for a program without spans."""
from __future__ import annotations

import sys

import pytest

from navbench import harness

READERS = {"predict.heatmap_ms": "predict.heatmap",
           "predict.net_ms": "predict.net",
           "predict.cluster_ms": "predict.cluster"}
TRACED = {"traces": {"predict": {"wall_s": 0.48, "busy_s": 0.46}}}


@pytest.fixture
def registry(monkeypatch):
    """The program's registry, replaced by a dict the test fills."""
    from dyobav_tpu_torch.utils import profiling

    fake = {}
    monkeypatch.setattr(profiling, "summary", lambda: dict(fake))
    return fake


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_gives_device_ms_a_call(metric, registry):
    read = harness.load_module("metrics", metric).read
    registry[READERS[metric]] = {"count": 3, "host_s": 0.002,
                                 "device_s": 0.4509}
    registry["predict"] = {"count": 3, "host_s": 0.47, "device_s": 0.4644}
    assert read(TRACED) == pytest.approx(150.3)
    assert read({}) is None                   # not a traced predictor run
    assert read({"traces": {"escalated": {}}}) is None
    registry[READERS[metric]]["device_s"] = None  # a rehearsal on the CPU
    assert read(TRACED) is None
    del registry[READERS[metric]]
    assert read(TRACED) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_of_a_program_without_spans(metric, registry, monkeypatch):
    from dyobav_tpu_torch import utils

    read = harness.load_module("metrics", metric).read
    registry[READERS[metric]] = {"count": 3, "host_s": 0.002,
                                 "device_s": 0.4509}
    assert read(TRACED) is not None
    # A program without spans: importing the module raises ImportError.
    monkeypatch.delattr(utils, "profiling")
    monkeypatch.setitem(sys.modules, "dyobav_tpu_torch.utils.profiling",
                        None)
    assert read(TRACED) is None
