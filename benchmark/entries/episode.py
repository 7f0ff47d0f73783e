"""The episode loop (ActiveMapper.test_navigation), as a user runs it.

Set-up runs the episode from step 0 through its first `setup_plans`
planning events (the initial scan, the first mapping events, the recon
update at step 0).  The window continues the same loop: mapping every
`map_every` steps, planning whenever the queue empties, the recon metric
every 25 steps against the scene's ground-truth cloud, no held-out
evaluation.  It ends at the first step boundary after --seconds.

The check, once the window has closed: the first Adam step of the
last mapping event whose first step draws two different frames, or of
the last event where none does (a step that draws one frame twice cannot
show half of its batch left out): its loss, its gradient as the
optimizer got it, and the change it made; the final map rendered at the last
keyframes (projection, binning, K1), and the recon metric's
ground-truth-to-map distances (the 1-NN), each against the plain
reference worked out from the map and frames of that call.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import port
from harness.trace import Tracer
from reference import compare, recon
from reference import gaussians as ref

# operations per live pair and channel, from the kernels' own counts
# (frozen with the peaks in harness/roofline.py)
from harness.roofline import blend_bound_s


class MappingCapture:
    """Keeps the inputs of a mapping event and of its first Adam step (the
    parameters, the gradient as the optimizer gets it and the parameters
    it returns), by wrapping the port's module functions: the latest event
    whose first step draws two different frames, or the latest event while
    none has; and, while traced, each event's starting map and frame
    choices for the rooflines.  The state is replaced, not written in
    place, so a kept event's tensors stay as they were."""

    def __init__(self, slam_mod, tracer: Tracer):
        self.mod = slam_mod
        self.last = None
        self.cur = None
        self.traced: list[dict] = []
        phase0, adam0 = slam_mod._mapping_phase_impl, slam_mod.adam_step
        self._orig = (phase0, adam0)

        def mixed(event):
            first = event["choices"][:1].ravel()
            return first.size > 1 and bool((first != first[0]).any())

        def phase(state, kf_colors, kf_depths, kf_w2cs, frame_choices, *a,
                  **kw):
            self.cur = dict(
                params={k: v.detach() for k, v in state.params().items()},
                n_active=state.n_active, kf_colors=kf_colors,
                kf_depths=kf_depths, kf_w2cs=kf_w2cs,
                choices=np.asarray(frame_choices),
                settings=kw.get("settings"), mc=kw.get("mc"),
                camera=kw.get("camera"))
            if tracer.on:
                self.traced.append(self.cur)
            out = phase0(state, kf_colors, kf_depths, kf_w2cs, frame_choices,
                         *a, **kw)
            if self.last is None or mixed(self.cur) or not mixed(self.last):
                self.last = self.cur
            self.cur = None
            return out

        def adam(opt, params, grads, lrs, *a, **kw):
            new, opt2 = adam0(opt, params, grads, lrs, *a, **kw)
            if self.cur is not None and opt.count == 0:
                self.cur.update(grads=grads, stepped=new, lrs=lrs)
            return new, opt2

        slam_mod._mapping_phase_impl = phase
        slam_mod.adam_step = adam

    def restore(self):
        self.mod._mapping_phase_impl, self.mod.adam_step = self._orig


def run(r):
    p = r.params
    import fisher_nerf_customized_tpu_torch.models.slam as slam_mod
    with r.setup_part("kernels"):
        port.load_kernels(r.device)
    mapper, _sim, _scene, gt = port.build_episode(r, r.workdir)
    slam = mapper.slam
    tracer = Tracer()
    cap = MappingCapture(slam_mod, tracer)
    if r.trace:
        tracer.mirror_phases(mapper.timer)
    map_every = int(mapper.cfg.map_every)
    st = dict(phase="setup", t0=0, steps=0, events=0)

    track0 = slam.track_rgbd

    def track(color, depth, gt_w2c=None, action=None):
        maps = slam.initialized and (slam.frame_idx + 2) % map_every == 0
        if st["phase"] != "window" or not maps:
            return track0(color, depth, gt_w2c=gt_w2c, action=action)
        i = st["events"]
        st["events"] += 1
        if not r.trace:
            return track0(color, depth, gt_w2c=gt_w2c, action=action)
        if tracer.on:
            with tracer.mark(f"map:{i}"):
                return track0(color, depth, gt_w2c=gt_w2c, action=action)
        # spanned once the profiler is off: it slows the host threefold
        with r.span("mapping_event_ms"):
            return track0(color, depth, gt_w2c=gt_w2c, action=action)
    slam.track_rgbd = track

    timer = mapper.timer

    def on_step(t, _obs):
        if st["phase"] == "setup":
            if len(mapper.plan_log) >= int(p["setup_plans"]):
                r.start_window()
                st.update(phase="window", t0=t)
                if r.trace:
                    tracer.start()
            return
        if st["phase"] != "window":
            return
        st["steps"] = t - st["t0"]
        done = r.window_elapsed() >= r.seconds
        if tracer.on and (done or st["events"] >= int(p["trace_events"])):
            tracer.stop()
            r.values["traced_steps"] = st["steps"]
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
    if st["phase"] != "done":
        raise RuntimeError(f"the episode ended ({result['done_reason']}) "
                           f"before the window did")
    r.setup_parts["map_building_and_warm_steps"] = r.t_setup_end - t_ep
    r.attempted = st["steps"]
    r.values.update(steps=st["steps"], events=st["events"])
    # the window's recon updates, those under the profiler left out
    t_from = max(r.t_window[0], st.get("trace_end", 0.0))
    rec = [dt * 1e3 for name, t0, dt in timer.events
           if name == "recon_metric" and t_from <= t0 <= r.t_window[1]]
    if rec:
        r.spans["recon_update_ms"] = rec
    r.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                           if r.device != "cpu" else 0)

    # -- after the window: the program's outputs kept, its state freed ---
    cam = port.camera_of(slam.camera)
    last = cap.last
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
    renders = {k: v.detach() for k, v in renders.items()}
    if r.trace:
        with r.timed("trace_reduce"):
            r.trace_summary = tracer.reduce()
        with r.timed("roofline_work"):
            r.work.update(mapping_work(cap.traced))
    del mapper, slam, result, cap
    gc.collect()
    if r.device != "cpu":
        torch.cuda.empty_cache()
    if n_est != len(est):
        raise RuntimeError(f"recon metric saw {n_est} points, the cloud "
                           f"holds {len(est)}")
    sample = np.random.default_rng(r.seed).choice(
        len(gt), size=min(int(p["recon_sample"]), len(gt)), replace=False)
    with r.timed("check_mapping_step"):
        check_mapping_step(r, last)
    with r.timed("check_renders"):
        check_renders(r, params, n_active, kf_c2w, renders, cam, k_now)
    with r.timed("check_recon"):
        check_recon(r, gt[sample], est, d_port[sample])


def _ref_mapping_grads(last, cam, dtype):
    """The loss and gradient of the event's first step by the reference,
    at `dtype`: the mean RGB-D loss over the frames that step took, each
    rendered against its binning made from the event's starting map."""
    params = {k: v.detach().to(dtype).clone().requires_grad_()
              for k, v in last["params"].items()}
    n_active = int(last["n_active"])
    st, mc = last["settings"], last["mc"]
    losses = []
    for i in last["choices"][0].tolist():
        w2c = last["kf_w2cs"][i].to(dtype)
        with torch.no_grad():
            means_cam = params["means3D"] @ w2c[:3, :3].T + w2c[:3, 3]
            act = torch.arange(means_cam.shape[0],
                               device=means_cam.device) < n_active
            pr = ref.project(means_cam, torch.exp(params["log_scales"]),
                             params["unnorm_rotations"], cam, act)
            bins = ref.tile_bin(pr, cam, st.tile_size, st.max_per_tile)
        out = ref.render(params, n_active, w2c, cam, st.max_per_tile,
                         bins=bins, ts=st.tile_size, chunk=st.chunk)
        losses.append(ref.rgbd_loss(
            out["im"], out["depth"], last["kf_colors"][i].to(dtype),
            last["kf_depths"][i].to(dtype), mc.depth_weight, mc.im_weight))
    loss = torch.stack(losses).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: g.float() for k, g in zip(params, grads)}


def _first_adam_change(grads, lrs, eps=1e-15):
    """The change of Adam's first step from zero moments:
    -lr (g / 0.1) / (sqrt(g^2 (1 - 0.999) / (1 - 0.999)) + eps), in f32 as
    the bias corrections of step 1 leave it."""
    out = {}
    for k, g in grads.items():
        mu = (1 - 0.9) * g
        nu = (1 - 0.999) * (g * g)
        out[k] = -lrs[k] * ((mu / (1.0 - 0.9))
                            / (torch.sqrt(nu / (1.0 - 0.999)) + eps))
    return out


def check_mapping_step(r, last):
    """K2 (and K1 under it) in the timed path: the gradient of the last
    mapping event's first step, and the change that step made."""
    if last is None or "grads" not in last:
        r.check("mapping_grad_gap", float("inf"), r.limit("mapping_grad_gap"))
        return
    cam = port.camera_of(last["camera"])
    _loss, g_ref = _ref_mapping_grads(last, cam, torch.float32)
    g_port = {k: last["grads"][k].detach().float() for k in g_ref}
    change_port = {k: (last["stepped"][k] - last["params"][k]).detach()
                   for k in g_ref}
    change_ref = _first_adam_change(g_ref, last["lrs"])
    gap, leaf = compare.worst_leaf(g_port, g_ref)
    r.note("mapping_grad_gap_leaf", leaf)
    r.check("mapping_grad_gap", gap, r.limit("mapping_grad_gap"))
    r.check("mapping_step_gap", compare.worst_norm_gap(change_port,
                                                       change_ref)[0],
            r.limit("mapping_step_gap"))
    if r.control:
        _l, g_low = _ref_mapping_grads(last, cam, torch.bfloat16)
        r.control_check("mapping_grad_gap",
                        compare.worst_leaf(g_low, g_ref)[0])
        # how far float32 itself lies from float64 on this map: the
        # rounding that a gap of the program's may hold
        _l, g64 = _ref_mapping_grads(last, cam, torch.float64)
        r.note("ref32_vs_ref64_grad_gap", compare.worst_leaf(g_ref, g64))
        r.note("port_vs_ref64_grad_gap", compare.worst_leaf(g_port, g64))
        r.control_check("mapping_step_gap", compare.worst_norm_gap(
            _first_adam_change(g_low, last["lrs"]), change_ref)[0])


def _ref_render_stack(params, n_active, c2ws, cam, k, dtype):
    outs = []
    with torch.no_grad():
        p = {key: v.to(dtype) for key, v in params.items()}
        for c2w in c2ws:
            w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=dtype,
                                  device=p["means3D"].device)
            o = ref.render(p, n_active, w2c, cam, k[0], with_depth_sq=True,
                           chunk=k[1])
            outs.append(torch.cat([o["im"], o["depth"][..., None]], -1)
                        .float())
    return torch.stack(outs)


def check_renders(r, params, n_active, c2ws, renders, cam, k):
    """The final map at the last keyframes: colour and blended depth."""
    got = torch.cat([renders["render"], renders["depth_acc"][..., None]], -1)
    want = _ref_render_stack(params, n_active, c2ws, cam, k, torch.float32)
    r.check("render_gap", compare.rel_l2(got, want), r.limit("render_gap"))
    if r.control:
        low = _ref_render_stack(params, n_active, c2ws, cam, k,
                                torch.bfloat16)
        r.control_check("render_gap", compare.rel_l2(low, want))


def check_recon(r, gt, est, d_port):
    """The recon metric's running ground-truth-to-map distances, at a
    sample of the ground-truth points drawn from the seed, against the
    points the metric has taken in (the cloud is append-only)."""
    d_ref, idx = recon.nearest(gt, est)
    r.check("recon_dist_gap", compare.rel_rms(d_port, d_ref),
            r.limit("recon_dist_gap"))
    if r.control:
        r.control_check("recon_dist_gap", compare.rel_rms(
            recon.distances_float32(gt, est, idx), d_ref))


def mapping_work(traced: list[dict]) -> dict:
    """The rooflines' work in the traced mapping events: for each event,
    the bound of its K1 calls (one a frame it took, and the densifying
    render of the current frame) and of its K2 calls (one a frame it took),
    each counted on the event's starting map at the frame's pose."""
    k1, k2 = [], []
    for i, ev in enumerate(traced):
        cam = port.camera_of(ev["camera"])
        n_active = int(ev["n_active"])
        choices = ev["choices"].reshape(-1)
        uses = np.bincount(choices, minlength=len(ev["kf_w2cs"]))
        # the densifying render: the current frame, the window's last
        uses[len(uses) - 1] += 1
        poses, inverse = torch.unique(ev["kf_w2cs"].reshape(len(uses), -1),
                                      dim=0, return_inverse=True)
        counted = ref.live_pairs(ev["params"], n_active,
                                 poses.reshape(-1, 4, 4), cam,
                                 ev["settings"].tile_size)
        n_pix = cam.width * cam.height
        n_ch = 4                      # r, g, b and the blended depth
        b1 = b2 = 0.0
        for j, u in enumerate(inverse.tolist()):
            pairs, vis = counted[u]
            k2_calls = int(uses[j]) - (1 if j == len(uses) - 1 else 0)
            b1 += int(uses[j]) * blend_bound_s("k1", pairs, vis, n_pix, n_ch)
            b2 += k2_calls * blend_bound_s("k2", pairs, vis, n_pix, n_ch)
        k1.append((f"map:{i}", b1))
        k2.append((f"map:{i}", b2))
    return {"k1.map": k1, "k2.map": k2}
