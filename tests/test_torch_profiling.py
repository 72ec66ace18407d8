"""The port's spans and counters (`dyobav_tpu_torch.utils.profiling`) on
the CPU: off unless torch's profiler records, the predictor's stages in
order, outputs unchanged by tracing, and counter deltas as the counters
moved.  A tiny net on a small map and a small escalated solve keep the file
to a few seconds."""
import tracemalloc

import numpy as np
import pytest
import torch

from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.maps.transforms import ScaleOffsetReverseTransform
from dyobav_tpu_torch.models.wta_net import (ConvMultiHypoNet,
                                             backbone_fc_input)
from dyobav_tpu_torch.ops import engine, spd, stem
from dyobav_tpu_torch.ops.params import empty_params, pack, tuning_vector
from dyobav_tpu_torch.predictors.mmp import ObstacleSnapper
from dyobav_tpu_torch.sim.batch import make_wta_predictor
from dyobav_tpu_torch.utils import profiling

torch.set_num_threads(1)

HPX, WPX, N_HOR = 64, 72, 3
STAGES = ("predict.heatmap", "predict.net", "predict.cluster")
# An under-budgeted warm profile, so that the ladder's one stage runs;
# its (3, 2, 2) budget is 3 + 4 iterations.
SCFG = tcfg.SolverConfiguration(
    max_inner_iters=1, max_outer_iters=1, inner_iters_later=1,
    newton_substeps=1, initial_penalty=1250.0, cold_profile=(3, 2, 2, 1, 10.0),
    escalation_ladder=((3, 2, 2, 1, 10.0),), escalation_slots=(4,))


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def predict():
    torch.manual_seed(0)
    gray = np.full((HPX, WPX), 255.0, np.float32)
    gray[20:40, 30:50] = 0.0                            # one shelf
    net = ConvMultiHypoNet(num_hypos=4, fc_input=backbone_fc_input(
        HPX, WPX, channels=16), channels=(4, 8, 8, 16), blocks=(1, 1, 1, 1),
        stem_features=8).eval()
    transform = ScaleOffsetReverseTransform(
        scale=0.1, offsetx_after=-3.0, offsety_after=-3.0, y_reverse=True,
        y_max_before=HPX)
    return make_wta_predictor(
        net, gray, transform, N_HOR,
        snap_tables=ObstacleSnapper(255.0 - gray).tables(), max_clusters=2,
        device="cpu")


def _hist():
    walk = [[-1.0 + 0.2 * i, 0.5 + 0.1 * i] for i in range(5)]
    turn = [[1.5, -1.0 + 0.25 * i] for i in range(5)]
    return torch.tensor([walk, turn], dtype=torch.float32)[:, :, None, :]


@pytest.fixture(scope="module")
def problems():
    """(bundle, Z, U0): four problems of an ellipse ahead of the robot."""
    cfg, N = tcfg.MpcConfiguration(), tcfg.MpcConfiguration().N_hor
    bundle = engine.build_mpc_solver(cfg, tcfg.CircularRobotSpecification(),
                                     SCFG, device="cpu")
    rng = np.random.default_rng(0)
    zs = []
    for _ in range(4):
        ref = torch.zeros(N, 3)
        ref[:, 0] = 0.24 * torch.arange(1, N + 1)
        ell = torch.zeros(cfg.Ndynobs, N + 1, cfg.ndynobs)
        ell[0] = torch.tensor([2.2, rng.uniform(-0.4, 0.4), 0.4, 0.4, 0.0,
                               1.0])
        zs.append(pack(empty_params(cfg)._replace(
            u_prev=torch.tensor([1.2, 0.0]), sN=ref[-1],
            q=torch.as_tensor(tuning_vector(cfg), dtype=torch.float32),
            ref_states=ref, ref_speed=torch.full((N,), 1.2), dyn_obs=ell,
            q_stc=torch.full((N,), 10.0), q_dyn=torch.full((N,), 10.0))))
    U0 = torch.tensor([1.2, 0.0]).repeat(4, N)
    return bundle, torch.stack(zs), U0


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_off_enters_no_record_function_and_records_nothing(predict,
                                                           monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: calls.append("event"))
    assert not profiling.active()
    t = torch.zeros(1)
    noop = profiling.span("predict", t)
    assert profiling.span("solve.warm", t) is noop    # one shared no-op
    assert profiling.lane_counter("newton.iterations", torch.zeros(4)) is None
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("predict.net", t):
                pass
        grown = tracemalloc.take_snapshot().compare_to(before, "filename")
    finally:
        tracemalloc.stop()
    assert not [d for d in grown if d.size_diff
                and d.traceback[0].filename == profiling.__file__]
    predict(_hist())
    assert calls == [] and profiling.summary() == {}


def test_predictor_spans_nest_in_order_as_annotations(predict):
    _, prof = _profiled(lambda: predict(_hist()))
    s = profiling.summary()
    # The tiny net's lite stem factors: its span sits inside the net's.
    assert set(s) == {"predict", "predict.stem", *STAGES}
    for name in s:
        assert s[name]["count"] == 1 and s[name]["device_s"] is None
        assert s[name]["host_s"] > 0
    assert sum(s[n]["host_s"] for n in STAGES) <= s["predict"]["host_s"]
    marks = {e.name: e for e in prof.events() if e.name in s}
    assert set(marks) == set(s)
    assert all(e.is_user_annotation for e in marks.values())
    outer = marks["predict"].time_range
    inner = [marks[n].time_range for n in STAGES]
    assert all(outer.start <= r.start and r.end <= outer.end for r in inner)
    assert all(a.end <= b.start for a, b in zip(inner, inner[1:]))
    net, stem_span = marks["predict.net"].time_range, marks[
        "predict.stem"].time_range
    assert net.start <= stem_span.start and stem_span.end <= net.end


def test_predictor_outputs_bit_identical_with_spans_on(predict):
    off = predict(_hist())
    on, _ = _profiled(lambda: predict(_hist()))
    assert profiling.summary()["predict"]["count"] == 1
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_escalated_solve_bit_identical_with_spans_and_lane_counter(
        problems, monkeypatch):
    bundle, Z, U0 = problems
    off = bundle.solve_batch_escalated(Z, U0)
    syncs = engine.any_lane.syncs
    # Spans on without the profiler's own cost on every operator.
    monkeypatch.setattr(profiling, "active", lambda: True)
    on = bundle.solve_batch_escalated(Z, U0)
    monkeypatch.undo()
    for f in off._fields:
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    s = profiling.summary()
    assert {"solve.escalated", "solve.warm", "solve.stage.0",
            "newton.iteration"} <= set(s)
    esc = s["solve.escalated"]
    assert esc["count"] == 1
    assert esc["any_lane.syncs"] == engine.any_lane.syncs - syncs == 1
    assert esc["to_host.syncs"] == 0 and s["solve.stage.0"]["count"] == 1
    # The warm profile runs one iteration a lane, the stage at most 7 on
    # each of its four slots.
    assert s["solve.warm"]["newton.iterations"] == {"p50": 1.0, "p95": 1.0,
                                                    "max": 1}
    stage = s["solve.stage.0"]["newton.iterations"]
    assert 1 <= stage["p50"] <= stage["p95"] <= stage["max"] <= 7
    assert s["newton.iteration"]["count"] == 1 + 7
    assert "newton.iterations" not in s["solve.escalated"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_newton_iterations_count_each_lane_until_done(fused, monkeypatch):
    """A bounded quadratic per lane: lanes 0 and 1 start at their optimum
    and stop after one iteration, lane 2 runs on; 3 + 4 iterations in all,
    in both loops (the staged one keeps a lane that met the constraints)."""
    from dyobav_tpu_torch.ops.newton import make_alm_newton_solver

    def objective(u, p):
        return (torch.sum((u - p) ** 2), u[:1] + u[1:], torch.zeros(1))

    scfg = tcfg.SolverConfiguration(
        fused=fused, linear_solver="cholesky", max_inner_iters=3,
        max_outer_iters=2, inner_iters_later=2, newton_substeps=1,
        initial_penalty=10.0, cold_profile=None)
    solve = make_alm_newton_solver(
        objective, torch.full((2,), -1.0), torch.full((2,), 1.0),
        torch.full((1,), -1.0), torch.full((1,), 1.0), scfg)
    P = torch.tensor([[0.2, 0.1], [-0.3, 0.4], [0.9, 0.8]])
    U0 = torch.tensor([[0.2, 0.1], [-0.3, 0.4], [-0.9, -0.9]])
    off = solve(U0, P)
    monkeypatch.setattr(profiling, "active", lambda: True)
    with profiling.span("solve", U0):
        on = solve(U0, P)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    s = profiling.summary()
    assert s["newton.iteration"]["count"] == 3 + 4
    assert s["solve"]["newton.iterations"]["p50"] == 1.0
    assert 1 < s["solve"]["newton.iterations"]["max"] <= 7


def test_counter_deltas_follow_the_counters():
    t, mask = torch.arange(3.0), torch.tensor([False, True])

    def work():
        before = (engine.any_lane.syncs, engine.to_host.syncs,
                  spd.spd_solve.launches, stem.stem_expand_pool.launches)
        with profiling.span("outer", t):
            engine.any_lane(mask)
            with profiling.span("inner", t):
                engine.to_host(t)
                engine.to_host(t)
                # What a launch of the stem kernel adds (the CPU: none).
                stem.stem_expand_pool.launches += 1
            # What a launch of the SPD kernel adds (the CPU launches none).
            spd.spd_solve.launches += 3
        return before

    before, _ = _profiled(work)
    after = (engine.any_lane.syncs, engine.to_host.syncs,
             spd.spd_solve.launches, stem.stem_expand_pool.launches)
    s = profiling.summary()
    assert [s["outer"][c] for c in profiling.COUNTERS] == [
        b - a for a, b in zip(before, after)] == [1, 2, 3, 1]
    assert [s["inner"][c] for c in profiling.COUNTERS] == [0, 2, 0, 1]


def test_summary_on_the_cpu_and_reset():
    def work():
        with profiling.span("a", torch.zeros(2)):
            lanes = profiling.lane_counter("n", torch.zeros(4))
            lanes += torch.tensor([0, 1, 2, 9], dtype=torch.int32)
        with profiling.span("a", torch.zeros(1)):
            pass

    _profiled(work)
    s = profiling.summary()
    assert s["a"]["count"] == 2 and s["a"]["device_s"] is None
    assert s["a"]["n"] == {"p50": 1.5, "p95": pytest.approx(7.95), "max": 9}
    assert profiling.summary() == s               # reading folds nothing away
    profiling.reset()
    assert profiling.summary() == {}
