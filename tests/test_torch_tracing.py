"""The port's spans and counters (utils/logging_utils.py: STORE, span,
count, StepTimer, profile_trace) on the CPU, on a short FakeSim episode at
the tests' small sizes (48x48, two mapping events of 8 Adam steps, two
planning events, an 8-pose evaluation):

  * every mapping event is one map.event span with map.steps map.step
    children, each with one map.step.loss, .grad and .adam child, and the
    parents as logging_utils' docstring lists them; render.pose counts
    the poses that render_at_poses renders;
  * the store keeps the newest records of each name apart, so a busy name
    pushes out no other name's records;
  * with no profiler running no record_function range is entered, on any
    path; under a profiler every span is a phase:<name> range, and the
    clock anchor lays a span's record within 1 ms of its range;
  * map.n_active is kept as the state's 0-d tensor (or the count already
    cached), not read on the event's path, and reads as the live count;
  * profile_trace's Chrome trace carries phase:map.step.
"""
import json

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults
from fisher_nerf_customized_tpu_torch.engine.driver import ActiveMapper
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu_torch.models import slam as slam_mod
from fisher_nerf_customized_tpu_torch.ops.camera import Camera
from fisher_nerf_customized_tpu_torch.ops.rasterize import render
from fisher_nerf_customized_tpu_torch.utils import logging_utils as lu

IMG = 48
STEPS = 14           # mapping events at steps 5 and 11
EVAL_POSES = 8


def episode_cfg(tmp_path):
    """tests/test_engine.py's episode settings, in the port's config."""
    cfg = get_cfg_defaults()
    cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
        fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
        width=IMG, height=IMG))
    cfg.workdir = str(tmp_path)
    cfg.run_name = "ep"
    cfg.policy.name = "gaussians_based"
    cfg.policy.planning_queue_size = 8
    cfg.num_frames = STEPS
    cfg.map_every = 6
    cfg.keyframe_every = 4
    cfg.downsample_pcd = 2
    cfg.mapping.num_iters = 8
    cfg.forward_step_size = 0.15
    cfg.turn_angle = 30.0
    cfg.explore.cell_size = 0.1
    cfg.explore.sample_view_num = 16
    cfg.explore.frontier_select_method = "combined"
    cfg.tpu.capacity = 8192
    cfg.tpu.tile_size = 8
    cfg.tpu.max_per_tile = 512
    cfg.tpu.pose_chunk = 4
    return cfg


def make_mapper(tmp_path):
    cam = Camera(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                 width=IMG, height=IMG)
    scene = BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                     obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0, seed=3,
                  device="cpu")
    return ActiveMapper(episode_cfg(tmp_path), sim, scene=scene, seed=0,
                        device="cpu"), scene


class CountingRange:
    """Stands in for torch.profiler.record_function and counts entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingRange.entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def episode(tmp_path_factory):
    """One episode with a fresh store and record_function counted: (the
    store, the mapper, the mapping events' count, the ranges entered)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    store = lu.SpanStore()
    CountingRange.entered = 0
    events = []
    event0 = slam_mod.GaussianSLAM._mapping_event

    def event(self, *a, **kw):
        events.append(len(events))
        return event0(self, *a, **kw)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lu, "STORE", store)
            mp.setattr(torch.profiler, "record_function", CountingRange)
            mp.setattr(slam_mod.GaussianSLAM, "_mapping_event", event)
            mapper, scene = make_mapper(tmp_path_factory.mktemp("tracing"))
            mapper.test_navigation(
                n_eval_poses=EVAL_POSES,
                recon_gt_points=scene.sample_surface_points(2000))
        yield store, mapper, len(events), CountingRange.entered
    finally:
        torch.set_num_threads(threads)


def _children(store, name, parent):
    return [r for r in store.records(name) if r.parent_id == parent.id]


def test_mapping_event_spans_and_parents(episode):
    store, _mapper, n_events, _entered = episode
    events = store.records("map.event")
    assert n_events == 2 and len(events) == n_events
    steps = [int(v) for _t, v in store.counts("map.steps")]
    assert steps == [8, 8]
    for ev, n_steps in zip(events, steps):
        assert ev.parent == "tracking_mapping"
        for name in ("map.densify", "map.window", "map.bin", "map.compact"):
            assert len(_children(store, name, ev)) == 1, name
        step_recs = _children(store, "map.step", ev)
        assert len(step_recs) == n_steps
        for st in step_recs:
            for part in ("loss", "grad", "adam"):
                (child,) = _children(store, f"map.step.{part}", st)
                assert st.t0_ns <= child.t0_ns
                assert child.t0_ns + child.dt_ns <= st.t0_ns + st.dt_ns
            # the frame's render inside the loss: preprocess and blend
            (loss,) = _children(store, "map.step.loss", st)
            assert len(_children(store, "render.preprocess", loss)) == 1
            assert len(_children(store, "render.blend", loss)) == 1
    # the densifying render bins; the phase's renders use frozen bins
    assert {r.parent for r in store.records("render.bin")} >= {
        "map.densify"}
    assert all(r.parent != "map.step.loss"
               for r in store.records("render.bin"))
    # planning's sub-spans inside ActiveMapper's plan.global
    assert store.records("plan.global.candidates")
    assert {r.parent for r in store.records("plan.global.candidates")} \
        == {"plan.global"}
    assert {r.parent for r in store.records("plan.global.launch")} \
        == {"plan.global.candidates"}


def test_evaluation_spans(episode):
    store, mapper, _n, _entered = episode
    chunk = store.records("eval.render")
    assert len(chunk) == 1 and chunk[0].parent == "eval"
    for name in ("eval.poses", "eval.gt", "eval.metrics"):
        assert [r.parent for r in store.records(name)] == ["eval"]
    assert len(_children(store, "render.pose", chunk[0])) == EVAL_POSES
    fresh = lu.SpanStore()
    c2ws = np.stack([np.linalg.inv(w) for w in mapper.slam.poses_w2c[-5:]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lu, "STORE", fresh)
        mapper.slam.render_at_poses(c2ws)
    new = fresh.records("render.pose")
    assert len(new) == 5 and {r.parent for r in new} == {None}


def test_one_name_never_pushes_out_another(monkeypatch):
    store = lu.SpanStore()
    monkeypatch.setattr(lu, "STORE", store)
    timer = lu.StepTimer()
    for _ in range(30000):
        with lu.span("map.step"):
            pass
    with timer.phase("recon_metric"):
        pass
    assert len(store.records("map.step")) == lu.SpanStore.RING == 16384
    (rec,) = store.records("recon_metric")
    assert rec.parent is None
    assert [e[0] for e in timer.events] == ["recon_metric"]
    assert timer.summary()["recon_metric"]["count"] == 1


def test_no_range_without_a_profiler(episode):
    """The whole episode (mapping, renders, planning, recon, evaluation)
    entered no record_function range: no profiler was running."""
    _store, _mapper, _n, entered = episode
    assert entered == 0
    # the same patch point counts under a profiler
    CountingRange.entered = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", CountingRange)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with lu.span("map.event"):
                pass
    assert CountingRange.entered == 1


def _tiny_scene(seed=0, n=300):
    g = torch.Generator().manual_seed(seed)
    means = torch.stack([torch.rand(n, generator=g) * 4 - 2,
                         torch.rand(n, generator=g) * 4 - 2,
                         torch.rand(n, generator=g) * 4 + 1], -1)
    scales = torch.rand(n, 3, generator=g) * 0.1 + 0.02
    quats = torch.randn(n, 4, generator=g)
    opac = torch.rand(n, generator=g) * 0.7 + 0.2
    colors = torch.rand(n, 4, generator=g)
    return means, scales, quats, opac, colors


def test_ranges_under_a_profiler_and_the_anchor(monkeypatch):
    store = lu.SpanStore()
    monkeypatch.setattr(lu, "STORE", store)
    cam = Camera(fx=16.0, fy=16.0, cx=16.0, cy=16.0, width=32, height=32)
    timer = lu.StepTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with lu.span("warm"):       # the first range's one-time set-up
            pass
        with timer.phase("tracking_mapping"):
            with lu.span("map.event"):
                render(cam, *_tiny_scene())
    assert store.anchors
    ranges: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(lu.RANGE_PREFIX):
            ranges.setdefault(e.name()[len(lu.RANGE_PREFIX):], []).append(
                e.start_ns())
    names = set(store.spans)
    assert names == {"warm", "tracking_mapping", "map.event",
                     "render.preprocess", "render.bin", "render.blend"}
    assert set(ranges) == names
    for name in names:
        recs = store.records(name)
        assert len(ranges[name]) == len(recs) == 1
        lag = store.profiler_ns(recs[0].t0_ns) - ranges[name][0]
        assert name == "warm" or abs(lag) < 1e6, (name, lag)
        assert abs(store.perf_ns(store.profiler_ns(recs[0].t0_ns))
                   - recs[0].t0_ns) == 0


def test_n_active_is_not_read_on_the_event_path(episode, monkeypatch):
    store0, mapper, _n, _entered = episode
    slam = mapper.slam
    store = lu.SpanStore()
    monkeypatch.setattr(lu, "STORE", store)
    sim = mapper.sim
    obs = sim.get_observations()
    color, depth = slam._prep_inputs(obs["rgb"], obs["depth"])
    w2c = np.linalg.inv(obs["c2w"]).astype(np.float32)
    # a state version whose count nobody has read: the tensor is kept
    slam.state = slam.state
    live = slam.state.n_active
    slam._mapping_event(color, depth, w2c, slam.frame_idx + 1)
    # the count already read for the current version: that int is kept
    cached = slam.n_active
    slam._mapping_event(color, depth, w2c, slam.frame_idx + 1)
    (t0, v0, _p0), (t1, v1, _p1) = store.counters["map.n_active"]
    assert v0 is live
    assert isinstance(v1, int) and v1 == cached
    assert [v for _t, v in store.counts("map.n_active")] == [
        float(int(live)), float(cached)]
    # the episode's own records read as its counts
    assert all(0 < v <= c for (_t, v), (_u, c) in zip(
        store0.counts("map.n_active"), store0.counts("map.capacity")))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_profile_trace_carries_the_spans(tmp_path, monkeypatch, one_thread):
    monkeypatch.setattr(lu, "STORE", lu.SpanStore())
    mapper, _scene = make_mapper(tmp_path / "ep")
    slam, sim = mapper.slam, mapper.sim
    obs = sim.get_observations()
    slam.track_rgbd(obs["rgb"], obs["depth"],
                    gt_w2c=np.linalg.inv(obs["c2w"]))
    color, depth = slam._prep_inputs(obs["rgb"], obs["depth"])
    slam.mc = slam.mc._replace(num_iters=2)
    with lu.profile_trace(str(tmp_path / "trace")):
        slam._mapping_event(color, depth,
                            np.linalg.inv(obs["c2w"]).astype(np.float32), 1)
    (path,) = (tmp_path / "trace").glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"phase:map.event", "phase:map.step",
            "phase:map.step.grad"} <= names
