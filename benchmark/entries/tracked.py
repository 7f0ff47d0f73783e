"""The episode loop with every frame's pose tracked (tracking.use_gt_poses
false), as a user runs it.

The loop is eccv_episode's (entries/episode.py): set-up runs the episode
from step 0 through its first `setup_plans` planning events, every frame
after the first tracked; the window continues the same loop (tracking
each frame, mapping every `map_every` steps on the tracked poses, plans
as the queue empties, the recon metric every 25 steps) to the first step
boundary after --seconds.  A traced run starts its profiler when the
next mapping event is `trace_track_frames` steps away (at the window's
start if it is nearer), so that the traced stretch holds those tracked
frames, each marked `track:{i}`, and `trace_events` mapping events, each
marked `map:{i}` (the event alone, without the frame's tracking); the
span readers then have the rest of the window's frames, untraced.

The check, once the window has closed: the first Adam step of the first
tracking phase of the window's last tracked frame, as the timed path
itself made it (the map, the frame, the start pose, the loss of the
first iteration, the gradient the step was given and the pose after
it), against the plain reference (reference/tracking.py) worked out from
that map, frame and pose, the step from the reference's own gradient;
then eccv_episode's four checks (the mapping step, the renders, the
recon), since mapping now runs on tracked poses.  Noted, not compared:
that phase worked out whole by the reference from the same start pose,
and whether the port kept the pose of its lowest loss.
The capture wraps the port's module functions _tracking_phase and
_tracking_loss and reads no span of the port.
"""
from __future__ import annotations

import gc
import time
from contextlib import nullcontext

import numpy as np
import torch

from entries.episode import (MappingCapture, check_mapping_step,
                             check_recon, check_renders, mapping_work)
from harness import port
from harness.roofline import blend_bound_s
from harness.spans import window_spans
from harness.trace import Tracer
from reference import compare
from reference import gaussians as ref
from reference import tracking as rtrack


class TrackingCapture:
    """Keeps, of the latest tracked frame between `begin_frame` and
    `end_frame`, what its first tracking phase was given and made in its first Adam
    step, by wrapping the port's _tracking_phase and _tracking_loss: the
    map (the state's tensors, replaced and never written in place by the
    episode), the frame, the camera and settings, (q0, t0), the first
    iteration's loss, the gradient of (q, t) that autograd handed the
    step (hooks on the leaves), and the pose that the second iteration
    took; and of that phase the pose before each iteration, its losses
    and the best pose it returned.  While a frame is recorded, each
    iteration's pose is kept too, for the rooflines.  Counts the frames
    that ran a second phase."""

    def __init__(self, slam_mod):
        self.mod = slam_mod
        self._orig = (slam_mod._tracking_phase, slam_mod._tracking_loss)
        phase0, loss0 = self._orig
        self.last = None          # the kept frame's first phase
        self.cur = None           # the phase being kept
        self.keep = False
        self.poses = None         # each iteration's (q, t) while recording
        self.phases = 0           # phases of the current frame
        self.doubled = 0

        def phase(state, q0, t0, gt_color, gt_depth, camera, settings, tc):
            self.phases += 1
            if self.keep and self.phases == 1:
                self.cur = dict(
                    params={k: v.detach() for k, v in state.params().items()},
                    n_active=state.n_active, color=gt_color, depth=gt_depth,
                    q0=q0.detach(), t0=t0.detach(), camera=camera,
                    settings=settings, tc=tc)
            try:
                out = phase0(state, q0, t0, gt_color, gt_depth, camera,
                             settings, tc)
                if self.cur is not None:
                    self.cur.update(best=(out[0].detach(), out[1].detach()),
                                    losses=out[4].detach())
                return out
            finally:
                if self.cur is not None and "q1" in self.cur:
                    self.last = self.cur
                self.cur = None

        def loss(cam_q, cam_t, *a, **kw):
            out = loss0(cam_q, cam_t, *a, **kw)
            if self.poses is not None:
                self.poses.append((cam_q.detach(), cam_t.detach()))
            cur = self.cur
            if cur is not None:
                cur.setdefault("iters", []).append((cam_q.detach(),
                                                    cam_t.detach()))
            if cur is not None and "loss" not in cur:
                cur["loss"] = out[0].detach()
                cam_q.register_hook(lambda g: cur.__setitem__("gq", g))
                cam_t.register_hook(lambda g: cur.__setitem__("gt", g))
            elif cur is not None and "q1" not in cur:
                cur["q1"], cur["t1"] = cam_q.detach(), cam_t.detach()
            return out

        slam_mod._tracking_phase = phase
        slam_mod._tracking_loss = loss

    def begin_frame(self, record: bool):
        self.keep, self.phases = True, 0
        self.poses = [] if record else None

    def end_frame(self):
        """The frame's recorded poses (None unless recorded)."""
        self.doubled += int(self.phases > 1)
        poses, self.poses, self.keep = self.poses, None, False
        return poses

    def restore(self):
        self.mod._tracking_phase, self.mod._tracking_loss = self._orig


def run(r):
    p = r.params
    import fisher_nerf_customized_tpu_torch.models.slam as slam_mod
    with r.setup_part("kernels"):
        port.load_kernels(r.device)
    mapper, _sim, _scene, gt = port.build_episode(r, r.workdir)
    slam = mapper.slam
    if slam.use_gt_poses:
        raise RuntimeError("the configuration tracks no pose: "
                           "tracking.use_gt_poses is true")
    tracer = Tracer()
    cap = MappingCapture(slam_mod, tracer)
    tcap = TrackingCapture(slam_mod)
    if r.trace:
        tracer.mirror_phases(mapper.timer)
    map_every = int(mapper.cfg.map_every)
    n_track = int(p["trace_track_frames"])
    st = dict(phase="setup", t0=0, steps=0, events=0, frames=0, traced=False,
              traced_events=0, marked_frames=0)
    traced_frames: list[tuple[str, dict, list]] = []
    window_poses: list[tuple[np.ndarray, np.ndarray]] = []

    def steps_to_event() -> int:
        """The steps up to and including the next one whose track_rgbd
        runs a mapping event (1: the next step)."""
        return (-(slam.frame_idx + 1)) % map_every or map_every

    event0 = slam._mapping_event

    def event(*a, **kw):
        if st["phase"] != "window":
            return event0(*a, **kw)
        st["events"] += 1
        if not tracer.on:
            return event0(*a, **kw)
        i = st["traced_events"]
        st["traced_events"] += 1
        with tracer.mark(f"map:{i}"):
            return event0(*a, **kw)
    slam._mapping_event = event

    track0 = slam._track_pose

    def track_pose(color, depth):
        if st["phase"] != "window":
            return track0(color, depth)
        st["frames"] += 1
        i = st["marked_frames"]
        record = tracer.on and i < n_track
        st["marked_frames"] += int(record)
        tcap.begin_frame(record)
        try:
            with tracer.mark(f"track:{i}") if record else nullcontext():
                return track0(color, depth)
        finally:
            poses = tcap.end_frame()
            if record:
                traced_frames.append((f"track:{i}", tcap.last, poses))
    slam._track_pose = track_pose

    rgbd0 = slam.track_rgbd

    def track_rgbd(color, depth, gt_w2c=None, action=None):
        out = rgbd0(color, depth, gt_w2c=gt_w2c, action=action)
        if st["phase"] == "window" and gt_w2c is not None:
            window_poses.append((np.asarray(gt_w2c, np.float64),
                                 np.asarray(slam.poses_w2c[-1], np.float64)))
        return out
    slam.track_rgbd = track_rgbd

    timer = mapper.timer

    def on_step(t, _obs):
        if st["phase"] == "setup":
            if len(mapper.plan_log) < int(p["setup_plans"]):
                return
            st.update(k0=slam.settings.max_per_tile, n0=slam.n_active)
            r.start_window()
            st.update(phase="window", t0=t)
        elif st["phase"] != "window":
            return
        st["steps"] = t - st["t0"]
        done = r.window_elapsed() >= r.seconds
        if (r.trace and not st["traced"] and not done
                and steps_to_event() <= n_track):
            st.update(traced=True, trace_from=t)
            tracer.start()
        if tracer.on and (done or st["traced_events"]
                          >= int(p["trace_events"])):
            tracer.stop()
            r.values["traced_steps"] = t - st["trace_from"]
            st["trace_end"] = time.perf_counter()
        if done:
            r.end_window()
            st["phase"] = "done"
            mapper.max_steps = t + 1         # the loop ends after this step
            # and without the episode's closing recon update: the check
            # reads the last update the window made
            mapper._recon_update = lambda _gt: {}

    t_ep = time.perf_counter()
    result = mapper.test_navigation(n_eval_poses=0, recon_gt_points=gt,
                                    on_step=on_step)
    r.after_parts["episode_end"] = time.perf_counter() - r.t_window[1]
    cap.restore()
    tcap.restore()
    if st["phase"] != "done":
        raise RuntimeError(f"the episode ended ({result['done_reason']}) "
                           f"before the window did")
    r.setup_parts["map_building_and_warm_steps"] = r.t_setup_end - t_ep
    r.attempted = st["steps"]
    r.values.update(steps=st["steps"], events=st["events"],
                    tracked_frames=st["frames"])
    t_from = max(r.t_window[0], st.get("trace_end", 0.0))
    rec = [dt * 1e3 for name, t0, dt in timer.events
           if name == "recon_metric" and t_from <= t0 <= r.t_window[1]]
    if rec:
        r.spans["recon_update_ms"] = rec
    r.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                           if r.device != "cpu" else 0)
    r.note("doubled_share", tcap.doubled / max(st["frames"], 1))
    # what a tracking step's work depends on, at the window's two ends
    r.note("max_per_tile", (st["k0"], slam.settings.max_per_tile))
    r.note("n_active", (st["n0"], slam.n_active))
    r.note("window_position_rmse_m", position_rmse(window_poses))

    # -- after the window: the program's outputs kept, its state freed ---
    cam = port.camera_of(slam.camera)
    last, track_last = cap.last, tcap.last
    n_est = mapper._inc_recon.n_est
    est = mapper.global_pcl.get()[:n_est]
    d_port = np.asarray(mapper._inc_recon.d_gt_min, np.float64)
    kf_c2w = [np.linalg.inv(w) for w in
              slam.keyframes.stacked_w2cs()[-int(p["check_poses"]):]]
    params = {k: v.detach() for k, v in slam.state.params().items()}
    n_active = slam.n_active
    k_now = (slam.settings.max_per_tile, slam.settings.chunk)
    with torch.no_grad():
        renders = slam.render_at_poses(np.stack(kf_c2w))
        if track_last is not None:
            # the port's own silhouette at the start pose, for a note
            track_last["sil"] = port_silhouette(slam_mod, track_last)
    renders = {k: v.detach() for k, v in renders.items()}
    if r.trace:
        with r.timed("trace_reduce"):
            r.trace_summary = tracer.reduce()
        with r.timed("roofline_work"):
            r.work.update(mapping_work(cap.traced))
            r.work.update(tracking_work(traced_frames))
        # the frames the span readers read: those after the traced stretch
        r.note("span_frames_read", len(window_spans(r, "track.frame")))
    del mapper, slam, result, cap, tcap, traced_frames
    gc.collect()
    if r.device != "cpu":
        torch.cuda.empty_cache()
    if n_est != len(est):
        raise RuntimeError(f"recon metric saw {n_est} points, the cloud "
                           f"holds {len(est)}")
    sample = np.random.default_rng(r.seed).choice(
        len(gt), size=min(int(p["recon_sample"]), len(gt)), replace=False)
    with r.timed("check_tracking_step"):
        check_tracking_step(r, track_last)
    with r.timed("note_tracking_phase"):
        note_tracking_phase(r, track_last)
    with r.timed("check_mapping_step"):
        check_mapping_step(r, last)
    with r.timed("check_renders"):
        check_renders(r, params, n_active, kf_c2w, renders, cam, k_now)
    with r.timed("check_recon"):
        check_recon(r, gt[sample], est, d_port[sample])


def position_rmse(pairs) -> float | None:
    """The root mean square distance between the sim's camera positions
    and the tracked ones over the window's frames, in metres (no
    alignment: the map's frame is the sim's, from the first frame)."""
    if not pairs:
        return None
    d = [np.linalg.norm(np.linalg.inv(g)[:3, 3] - np.linalg.inv(e)[:3, 3])
         for g, e in pairs]
    return float(np.sqrt(np.mean(np.square(d))))


def port_silhouette(slam_mod, kept):
    """The port's silhouette 1 - final T at the kept phase's start pose."""
    from fisher_nerf_customized_tpu_torch.utils.geometry import (
        quat_to_rotmat)
    w2c = torch.eye(4, device=kept["q0"].device)
    w2c[:3, :3] = quat_to_rotmat(kept["q0"])
    w2c[:3, 3] = kept["t0"]
    out = slam_mod._render_rgbd(kept["camera"], kept["settings"],
                                kept["params"], kept["n_active"], w2c)
    return out["sil"].detach()


def tracking_of(tc) -> rtrack.Tracking:
    """The reference's reading of the port's tracking settings."""
    return rtrack.Tracking(
        sil_thres=float(tc.sil_thres), depth_weight=float(tc.depth_weight),
        im_weight=float(tc.im_weight),
        use_sil_for_loss=bool(tc.use_sil_for_loss),
        ignore_outlier_depth_loss=bool(tc.ignore_outlier_depth_loss),
        lr_rot=float(tc.lr_rot), lr_trans=float(tc.lr_trans))


def _ref_first_step(kept, dtype):
    """reference/tracking.py's pose_grad at the kept start pose, at
    `dtype`."""
    cam = port.camera_of(kept["camera"])
    s = kept["settings"]
    params = {k: v.to(dtype) for k, v in kept["params"].items()}
    return rtrack.pose_grad(
        kept["q0"].to(dtype), kept["t0"].to(dtype), params,
        int(kept["n_active"]), kept["color"].to(dtype),
        kept["depth"].to(dtype), cam, tracking_of(kept["tc"]),
        s.max_per_tile, s.tile_size, s.chunk)


def _ref_change(kept, gq, gt_, dtype):
    """The pose change of the reference's first Adam step at `dtype`, from
    the gradient (gq, gt_), as float64 differences of that dtype's
    values."""
    q0, t0 = kept["q0"].to(dtype), kept["t0"].to(dtype)
    q1, t1, _opt = rtrack.adam_step(
        q0, t0, gq.to(dtype), gt_.to(dtype), rtrack.adam_init(q0, t0), 1,
        tracking_of(kept["tc"]))
    return dict(q=q1.double() - q0.double(), t=t1.double() - t0.double())


def check_tracking_step(r, kept):
    """K1, the masks and the SUMs (the loss), K2 and projection's backward
    to the pose (the gradient), and Adam's step on the pose, of the first
    step of the window's last tracked frame."""
    names = ("tracking_loss_gap", "tracking_grad_gap", "tracking_step_gap")
    if kept is None or "gq" not in kept or "q1" not in kept:
        for n in names:
            r.check(n, float("inf"), r.limit(n))
        return
    want = _ref_first_step(kept, torch.float32)
    g_port = dict(q=kept["gq"].float(), t=kept["gt"].float())
    g_ref = dict(q=want["gq"].float(), t=want["gt"].float())
    change_port = dict(q=kept["q1"].double() - kept["q0"].double(),
                       t=kept["t1"].double() - kept["t0"].double())
    # the reference's step from its own gradient
    change_ref = _ref_change(kept, g_ref["q"], g_ref["t"], torch.float32)
    grad_gap, leaf = compare.worst_leaf(g_port, g_ref)
    r.note("tracking_grad_gap_leaf", leaf)
    r.note("tracking_loss", (float(kept["loss"]), float(want["loss"])))
    if "sil" in kept:
        thres = float(kept["tc"].sil_thres)
        r.note("sil_pixels_differ", int(((kept["sil"] > thres).cpu()
                                         != (want["sil"] > thres).cpu())
                                        .sum()))
    r.check("tracking_loss_gap", compare.rel_l2(kept["loss"], want["loss"]),
            r.limit("tracking_loss_gap"))
    r.check("tracking_grad_gap", grad_gap, r.limit("tracking_grad_gap"))
    r.check("tracking_step_gap",
            compare.worst_leaf(change_port, change_ref)[0],
            r.limit("tracking_step_gap"))
    if r.control:
        low = _ref_first_step(kept, torch.bfloat16)
        r.control_check("tracking_loss_gap",
                        compare.rel_l2(low["loss"].float(), want["loss"]))
        r.control_check("tracking_grad_gap", compare.worst_leaf(
            dict(q=low["gq"].float(), t=low["gt"].float()), g_ref)[0])
        r.control_check("tracking_step_gap", compare.worst_leaf(
            _ref_change(kept, low["gq"], low["gt"], torch.bfloat16),
            change_ref)[0])


def note_tracking_phase(r, kept):
    """Notes, not compared: the kept phase worked out whole by the
    reference from the same start pose (its losses and its best pose
    against the port's), and whether the port kept the pose after the
    step of its own lowest loss (None when that was the last step, whose
    pose no loss saw).  Forward propagation and the doubled phase are
    not worked out again."""
    if kept is None or "losses" not in kept:
        return
    losses = kept["losses"].double().cpu()
    s = kept["settings"]
    best_q, best_t, _l, _dl, ref_losses = rtrack.phase(
        kept["q0"], kept["t0"], kept["params"], int(kept["n_active"]),
        kept["color"], kept["depth"], port.camera_of(kept["camera"]),
        tracking_of(kept["tc"]), len(losses), s.max_per_tile, s.tile_size,
        s.chunk)
    ref_losses = torch.tensor(ref_losses, dtype=torch.float64)
    r.note("tracking_phase_loss_gap",
           float((losses - ref_losses).abs().max() / ref_losses.abs().max()))
    r.note("tracking_phase_best_gap", compare.worst_leaf(
        dict(q=kept["best"][0], t=kept["best"][1]),
        dict(q=best_q, t=best_t))[0])
    k, poses = int(torch.argmin(losses)), kept["iters"]
    r.note("tracking_best_kept",
           bool(torch.equal(kept["best"][0], poses[k + 1][0])
                and torch.equal(kept["best"][1], poses[k + 1][1]))
           if k + 1 < len(poses) else None)


def tracking_work(traced: list) -> dict:
    """The rooflines' work in the traced tracked frames: one K1 and one K2
    call an iteration, each counted on the frame's map at that
    iteration's pose."""
    k1, k2 = [], []
    for mark, kept, poses in traced:
        if kept is None or not poses:
            continue
        cam = port.camera_of(kept["camera"])
        w2cs = torch.stack([rtrack.w2c_of(q.float(), t.float())
                            for q, t in poses])
        counted = ref.live_pairs(kept["params"], int(kept["n_active"]), w2cs,
                                 cam, kept["settings"].tile_size)
        n_pix = cam.width * cam.height
        n_ch = 4                      # r, g, b and the blended depth
        k1.append((mark, sum(blend_bound_s("k1", pairs, vis, n_pix, n_ch)
                             for pairs, vis in counted)))
        k2.append((mark, sum(blend_bound_s("k2", pairs, vis, n_pix, n_ch)
                             for pairs, vis in counted)))
    return {"k1.track": k1, "k2.track": k2}
