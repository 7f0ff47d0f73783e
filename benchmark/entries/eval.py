"""The held-out evaluation (engine/eval.py::eval_navigation) of a map.

Set-up runs the episode to step `map_steps` (the map that the window
evaluates), makes LPIPS(alex) weights on the card from --seed (random:
speed does not need the pretrained ones, which the repository does not
hold) and warms one chunk.  The window calls eval_navigation on chunks
of `chunk` navigable poses, each chunk's poses drawn from a seed of its
own made from --seed, one chunk after another, and ends at the first
chunk boundary after --seconds.

The check: one chunk of the window drawn from --seed, every pose of it
worked out again by the reference (its poses from the chunk's seed, the
ground-truth raycast of the scene's boxes, the map's render, PSNR, SSIM,
depth MAE and LPIPS from the same weights) and held to the program's
per-pose metrics.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from harness import port
from harness.roofline import blend_bound_s
from harness.trace import Tracer
from reference import gaussians as ref
from reference import image_metrics, poses as ref_poses, scene as ref_scene

ALEX = ((0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3), (8, 384, 256, 3),
        (10, 256, 256, 3))


def lpips_weights(seed: int, device) -> dict:
    """LPIPS(alex) at its published widths, random from the seed on the
    device: He-scaled convolutions, small biases, nonnegative 1x1 heads."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    w = {}
    for i, (idx, cin, cout, k) in enumerate(ALEX):
        w[f"features.{idx}.weight"] = torch.randn(
            cout, cin, k, k, generator=g, device=device) \
            * (2.0 / (cin * k * k)) ** 0.5
        w[f"features.{idx}.bias"] = 0.01 * torch.randn(cout, generator=g,
                                                       device=device)
        w[f"lin{i}.model.1.weight"] = torch.rand(
            1, cout, 1, 1, generator=g, device=device) / cout
    return w


def chunk_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + i) % (2 ** 63)


def run(r):
    p = r.params
    from fisher_nerf_customized_tpu_torch.engine import eval as eval_mod
    from fisher_nerf_customized_tpu_torch.models.perceptual import LPIPSAlex
    with r.setup_part("kernels"):
        port.load_kernels(r.device)
    mapper, sim, scene, _gt = port.build_episode(r, r.workdir, with_gt=False)
    with r.setup_part("map_building"):
        mapper.max_steps = int(p["map_steps"])
        mapper.test_navigation(n_eval_poses=0)
    slam = mapper.slam
    cam_height = float(sim.c2w[1, 3])
    chunk = int(p["chunk"])
    with r.setup_part("lpips_weights"):
        weights = lpips_weights(r.seed, r.device)
        net = LPIPSAlex()
        net.load_state_dict(weights)
        eval_mod._LPIPS_NET = net.to(r.device).eval()
    with r.setup_part("warm_chunk"):
        eval_mod.eval_navigation(slam, sim, scene, n_poses=chunk,
                                 cam_height=cam_height,
                                 seed=chunk_seed(r.seed, -1), chunk=chunk)
    tracer = Tracer()
    rows = []
    r.start_window()
    if r.trace:
        tracer.start()
    while True:
        i = len(rows)
        with tracer.mark(f"eval:{i}"):
            out = eval_mod.eval_navigation(
                slam, sim, scene, n_poses=chunk, cam_height=cam_height,
                seed=chunk_seed(r.seed, i), chunk=chunk)
        rows.append(out["per_pose"])
        if tracer.on and len(rows) >= int(p["trace_chunks"]):
            tracer.stop()
            r.values["traced_chunks"] = len(rows)
        if r.window_elapsed() >= r.seconds:
            break
    r.end_window()
    if tracer.on:
        tracer.stop()
    r.values.update(poses=chunk * len(rows), chunks=len(rows))
    r.attempted = chunk * len(rows)
    r.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                           if r.device != "cpu" else 0)

    params = {k: v.detach() for k, v in slam.state.params().items()}
    n_active = slam.n_active
    k_now = (slam.settings.max_per_tile, slam.settings.chunk)
    cam = port.camera_of(slam.camera)
    boxes = [torch.as_tensor(b, device=r.device) for b in scene.boxes()]
    if r.trace:
        with r.timed("trace_reduce"):
            r.trace_summary = tracer.reduce()
        with r.timed("roofline_work"):
            r.work["k1.eval"] = eval_work(
                params, n_active, cam, scene, cam_height, r.seed,
                r.values["traced_chunks"], chunk)
    eval_mod._LPIPS_NET = None
    del mapper, slam, sim, net
    gc.collect()
    if r.device != "cpu":
        torch.cuda.empty_cache()
    j = int(np.random.default_rng(r.seed).integers(len(rows)))
    with r.timed("check_chunk"):
        check_chunk(r, params, n_active, cam, k_now, scene, boxes,
                    cam_height, chunk_seed(r.seed, j), rows[j], weights)


def eval_work(params, n_active, cam, scene, cam_height, seed, n_chunks,
              chunk):
    """The bound of the K1 launches of the traced chunks: one a pose, with
    the five channels (r, g, b, z, z^2) of an evaluation render."""
    work = []
    n_pix = cam.width * cam.height
    for i in range(n_chunks):
        c2w = ref_poses.eval_poses(scene, chunk, cam_height,
                                   chunk_seed(seed, i))
        w2cs = torch.as_tensor(np.linalg.inv(c2w),
                               device=params["means3D"].device)
        counted = ref.live_pairs(params, n_active, w2cs, cam)
        work.append((f"eval:{i}", sum(blend_bound_s("k1", pairs, vis, n_pix, 5)
                                      for pairs, vis in counted)))
    return work


def _reference_rows(params, n_active, cam, k, boxes, c2ws, weights, dtype):
    dev = params["means3D"].device
    lo, hi, inward, seeds = boxes
    gt_rgb, gt_depth = ref_scene.raycast(
        lo, hi, inward, seeds, torch.as_tensor(c2ws, device=dev),
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
    p = {key: v.to(dtype) for key, v in params.items()}
    rows = []
    with torch.no_grad():
        for i, c2w in enumerate(c2ws):
            w2c = torch.as_tensor(np.linalg.inv(c2w), device=dev)
            o = ref.render(p, n_active, w2c, cam, k[0], with_depth_sq=True,
                           chunk=k[1])
            rows.append(image_metrics.pose_metrics(
                o["im"].float(), gt_rgb[i], o["med_depth"].float(),
                gt_depth[i], weights))
    return rows


def _gaps(got, want) -> dict:
    """The largest gap over the poses: PSNR in dB, SSIM and LPIPS as
    they are, depth MAE as a share of the reference's MAE of that pose or
    of the chunk's median pose, whichever is larger.  The median depth is
    that of the pair that takes T across 0.5 (the far plane where none
    does), so rounding flips a few pixels by up to the far plane's depth:
    against a pose whose own MAE is all but zero that is no measure."""
    floor = float(np.median([b["depth_mae"] for b in want]))
    return dict(
        eval_psnr_gap=max(abs(a["psnr"] - b["psnr"]) for a, b in zip(got, want)),
        eval_ssim_gap=max(abs(a["ssim"] - b["ssim"]) for a, b in zip(got, want)),
        eval_depth_mae_gap=max(abs(a["depth_mae"] - b["depth_mae"])
                               / max(b["depth_mae"], floor, 1e-12)
                               for a, b in zip(got, want)),
        eval_lpips_gap=max(abs(a["lpips"] - b["lpips"])
                           for a, b in zip(got, want)))


def check_chunk(r, params, n_active, cam, k, scene, boxes, cam_height, seed,
                got, weights):
    c2ws = ref_poses.eval_poses(scene, len(got), cam_height, seed)
    want = _reference_rows(params, n_active, cam, k, boxes, c2ws, weights,
                           torch.float32)
    for name, value in _gaps(got, want).items():
        r.check(name, value, r.limit(name))
    if r.control:
        low = _reference_rows(params, n_active, cam, k, boxes, c2ws, weights,
                              torch.bfloat16)
        for name, value in _gaps(low, want).items():
            r.control_check(name, value)
