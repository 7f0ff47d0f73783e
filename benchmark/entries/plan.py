"""Planning events (ActiveMapper._replan -> plan_best_path), one caller in
a closed loop.

Set-up runs the episode to step `map_steps` and computes H_train as
prewarm_H_train does, then warms one event.  Each request of the window
is one planning event from a pose drawn from --seed among the cells that
the planner's last search found free and connected to the agent (a
uniform yaw), the queue emptied before it, with no mapping in between;
the window ends at the first event boundary after --seconds.  An event
that raises (LocalizationError past its retries, NoFrontierError)
counts in `failed`.

The check: one event of the window drawn from --seed, worked out again
by the reference from the map, the keyframes and the poses that event
scored: H_train, each candidate's Fisher score (the reduced chain, K3's
11-wide function) and each path's EIG (the full chain, K3's 20-wide
one); the chosen path is the argmax of those scores, and how far it
falls short of the reference's best is noted beside them.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from harness import port
from harness.roofline import fisher_bound_s
from harness.trace import Tracer
from reference import compare
from reference import fisher as ref_fisher
from reference import gaussians as ref

CANDIDATE_PHASES = ("plan.global", "plan.sweep", "plan.global.wait")


class PlanCapture:
    """The inputs and outputs of each event's candidate scoring
    (pose_eval_async and its resolve) and path scoring (path_eig_scores),
    by wrapping the port's own functions."""

    def __init__(self, slam, driver_mod):
        self.events: list[dict] = []
        self.cur = None
        self.slam, self.mod = slam, driver_mod
        pose_eval0 = slam.pose_eval_async
        path0 = driver_mod.path_eig_scores
        self._orig = path0

        def pose_eval_async(poses, *a, **kw):
            resolve0 = pose_eval0(poses, *a, **kw)
            rec = dict(poses=np.asarray(poses, np.float32))
            if self.cur is not None:
                self.cur["candidates"] = rec

            def resolve():
                scores, out_poses = resolve0()
                rec["scores"] = scores
                return scores, out_poses
            return resolve

        def path_eig_scores(state, h_train, w2cs, valid, lengths, final_eigs,
                            *a, **kw):
            scores = path0(state, h_train, w2cs, valid, lengths, final_eigs,
                           *a, **kw)
            if self.cur is not None:
                self.cur["paths"] = dict(w2cs=w2cs, valid=valid,
                                         lengths=lengths,
                                         final_eigs=final_eigs,
                                         scores=scores)
            return scores

        slam.pose_eval_async = pose_eval_async
        driver_mod.path_eig_scores = path_eig_scores

    def begin(self):
        self.cur = {}

    def end(self, plan_log_entry):
        self.cur["best"] = None if plan_log_entry is None \
            else int(plan_log_entry["best"])
        self.events.append(self.cur)
        self.cur = None

    def restore(self):
        self.mod.path_eig_scores = self._orig
        del self.slam.pose_eval_async


def _c2w(x, z, cam_height, yaw):
    """The agent's camera at (x, cam_height, z) with a yaw about +y (x
    right, y down, z forward)."""
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) \
        @ np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = rot
    out[:3, 3] = [x, cam_height, z]
    return out


def run(r):
    p = r.params
    import fisher_nerf_customized_tpu_torch.engine.driver as driver_mod
    from fisher_nerf_customized_tpu_torch.planning.planner import (
        LocalizationError, NoFrontierError)
    with r.setup_part("kernels"):
        port.load_kernels(r.device)
    mapper, sim, _scene, _gt = port.build_episode(r, r.workdir,
                                                  with_gt=False)
    with r.setup_part("map_building"):
        mapper.max_steps = int(p["map_steps"])
        mapper.test_navigation(n_eval_poses=0)
    slam, planner = mapper.slam, mapper.planner
    with r.setup_part("h_train"):
        slam.prewarm_H_train()
    cam_height = float(sim.c2w[1, 3])
    # the free cells connected to the agent, `draw_margin` cells clear of
    # the free region's edge, so that every drawn pose localizes
    free = planner.free_space_np > 0
    for _ in range(int(p["draw_margin"])):
        free = (free & np.roll(free, 1, 0) & np.roll(free, -1, 0)
                & np.roll(free, 1, 1) & np.roll(free, -1, 1))
    rows, cols = np.nonzero(free)
    rng = np.random.default_rng(r.seed)

    def draw():
        i = int(rng.integers(len(rows)))
        x, z = planner.convert_to_world(np.array([cols[i] + 0.5,
                                                  rows[i] + 0.5]))
        return _c2w(float(x), float(z), cam_height,
                    float(rng.uniform(0, 2 * np.pi)))

    t_base = int(p["map_steps"]) + 1
    cap = PlanCapture(slam, driver_mod)
    tracer = Tracer()
    if r.trace:
        tracer.mirror_phases(mapper.timer)

    def event(i):
        c2w = draw()
        mapper.queue.clear()
        n_log = len(mapper.plan_log)
        cap.begin()
        ok = True
        # spanned once the profiler is off: it slows the host
        span = "plan_event_traced_ms" if tracer.on else "plan_event_ms"
        with r.span(span), tracer.mark(f"plan:{i}"):
            try:
                mapper._replan(c2w, t_base + i)
            except (NoFrontierError, LocalizationError) as e:
                ok = False
                r.notes.setdefault("failed_events", []).append(
                    (i, type(e).__name__, str(e)))
        cap.end(mapper.plan_log[-1] if len(mapper.plan_log) > n_log
                else None)
        return ok

    with r.setup_part("warm_event"):
        event(-1)
    cap.events.clear()
    r.spans.clear()
    timer = mapper.timer
    r.start_window()
    if r.trace:
        tracer.start()
    n, t_trace_end = 0, 0.0
    while True:
        r.failed += 0 if event(n) else 1
        n += 1
        if tracer.on and n >= int(p["trace_events"]):
            tracer.stop()
            t_trace_end = time.perf_counter()
        if r.window_elapsed() >= r.seconds:
            break
    r.end_window()
    if tracer.on:
        tracer.stop()
    cap.restore()
    r.attempted = n
    r.values.update(events=n)
    # per event, over the window's events that the profiler did not slow
    t_from = max(r.t_window[0], t_trace_end)
    cand = sum(dt for name, t0, dt in timer.events
               if name in CANDIDATE_PHASES and t0 >= t_from)
    spans = r.spans.get("plan_event_ms", [])
    if spans:
        r.spans["plan_candidates_ms"] = [cand * 1e3 / len(spans)]
        r.spans["plan_p90_ms"] = [statistics.quantiles(spans, n=10)[-1]
                                  if len(spans) >= 2 else spans[0]]
    r.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                           if r.device != "cpu" else 0)

    params = {k: v.detach() for k, v in slam.state.params().items()}
    n_active = slam.n_active
    fcam = port.camera_of(slam.fisher_camera)
    fs = slam.fisher_settings
    cfg = mapper.cfg
    fk = dict(ts=fs.tile_size, k=fs.max_per_tile, chunk=fs.chunk,
              grad_value=slam.fisher_grad_value)
    kf_w2cs = torch.as_tensor(slam.keyframes.stacked_w2cs(),
                              device=params["means3D"].device)
    window = slam.h_train_window
    weights = dict(h_reg_lambda=float(cfg.H_reg_lambda),
                   point_weight=float(cfg.path_point_weight),
                   end_weight=float(cfg.path_end_weight),
                   vol_weighted=bool(cfg.vol_weighted_H),
                   gs_pts_cnt=float(slam.gs_pts_cnt()))
    if slam.fisher_full_chain:
        raise ValueError("the check scores candidates with the reduced chain")
    if r.trace:
        with r.timed("trace_reduce"):
            r.trace_summary = tracer.reduce()
        with r.timed("roofline_work"):
            r.work["k3.plan"] = plan_work(
                params, n_active, fcam, fs.tile_size, cap.events,
                int(p["roofline_events"]), slam.pose_chunk)
    events = cap.events
    del mapper, slam, planner, cap
    gc.collect()
    if r.device != "cpu":
        torch.cuda.empty_cache()
    j = int(np.random.default_rng(r.seed).integers(len(events)))
    with r.timed("check_event"):
        check_event(r, params, n_active, fcam, fk, kf_w2cs, window, weights,
                    events[j])


def plan_work(params, n_active, fcam, ts, events, n_events, pose_chunk):
    """The bound of the K3 launches of the first traced events: the
    candidates' 11-wide scoring, padded to the pose chunk with
    identities, and the paths' 20-wide scoring at every (padded path,
    acc step) pose, each counted at its pose."""
    work = []
    dev = params["means3D"].device
    for i, ev in enumerate(events[:n_events]):
        if "candidates" not in ev:
            continue
        cand = np.linalg.inv(ev["candidates"]["poses"])
        pad = -len(cand) % pose_chunk
        cand = np.concatenate([cand, np.tile(np.eye(4, dtype=np.float32),
                                             (pad, 1, 1))])
        b = sum(fisher_bound_s(11, pairs, vis) for pairs, vis in
                ref.live_pairs(params, n_active,
                               torch.as_tensor(cand, device=dev), fcam, ts))
        if "paths" in ev:
            w2cs = ev["paths"]["w2cs"].reshape(-1, 4, 4)
            b += sum(fisher_bound_s(20, pairs, vis) for pairs, vis in
                     ref.live_pairs(params, n_active, w2cs, fcam, ts))
        work.append((f"plan:{i}", b))
    return work


def _reference_scores(params, n_active, fcam, fk, kf_w2cs, window, weights,
                      ev, dtype):
    p = {k: v.to(dtype) for k, v in params.items()}

    def fisher(w2cs, full=False):
        return ref_fisher.fisher_diag(p, n_active, w2cs.to(dtype), fcam,
                                      fk["ts"], fk["k"], fk["chunk"],
                                      fk["grad_value"], full)
    with torch.no_grad():
        h = ref_fisher.h_train(fisher, kf_w2cs, window)
        w2cs = torch.as_tensor(np.linalg.inv(ev["candidates"]["poses"]),
                               device=kf_w2cs.device)
        cand = ref_fisher.pose_scores(fisher, w2cs, h).double()
        paths = None
        if "paths" in ev:
            pa = ev["paths"]
            paths = ref_fisher.path_scores(
                lambda w: fisher(w, True), h, pa["w2cs"], pa["valid"],
                pa["lengths"], pa["final_eigs"], weights["h_reg_lambda"],
                weights["point_weight"], weights["end_weight"],
                weights["vol_weighted"], weights["gs_pts_cnt"]).double()
    return cand, paths


def _gaps(got_cand, got_paths, best, cand, paths) -> dict:
    out = dict(plan_candidate_gap=compare.rel_l2(got_cand, cand))
    if paths is not None and got_paths is not None:
        real = torch.isfinite(paths) & torch.isfinite(got_paths.double())
        want = paths[real]
        out["plan_path_gap"] = compare.rel_l2(got_paths.double()[real], want)
        # the chosen path's shortfall from the reference's best, as a
        # share of the spread of the reference's scores
        spread = float(want.max() - want.min())
        pick = float(paths[best]) if best is not None else float("-inf")
        out["plan_choice_gap"] = (float(want.max()) - pick) / max(spread,
                                                                 1e-12)
    return out


def check_event(r, params, n_active, fcam, fk, kf_w2cs, window, weights, ev):
    if "candidates" not in ev or "scores" not in ev["candidates"]:
        r.check("plan_candidate_gap", float("inf"),
                r.limit("plan_candidate_gap"))
        return
    cand, paths = _reference_scores(params, n_active, fcam, fk, kf_w2cs,
                                    window, weights, ev, torch.float32)
    got_paths = ev.get("paths", {}).get("scores")
    gaps = _gaps(ev["candidates"]["scores"], got_paths, ev["best"], cand,
                 paths)
    for name in ("plan_candidate_gap", "plan_path_gap"):
        r.check(name, gaps.get(name, float("inf")), r.limit(name))
    r.note("plan_choice_gap", gaps.get("plan_choice_gap"))
    if r.control:
        c_low, p_low = _reference_scores(params, n_active, fcam, fk, kf_w2cs,
                                         window, weights, ev, torch.bfloat16)
        best_low = int(torch.argmax(p_low)) if p_low is not None else None
        for name, value in _gaps(c_low, p_low, best_low, cand,
                                 paths).items():
            r.control_check(name, value)
