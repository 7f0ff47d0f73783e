"""The behavioural check of the policies: FisherRF (gaussians_based) and
FBE (frontier) on the same FakeSim scene and seeds at the eccv operating
point, each row the 3D completeness, accuracy and FPR at 5 cm, the AUC,
the 2D coverage, the PSNR over 60 held-out poses and the wall time (the
JAX package's scripts/quality_check.py, the same JSON rows).  FisherRF
is expected at or above FBE in completeness and AUC.

    python -m fisher_nerf_customized_tpu_torch.tools.quality_check \\
        [--steps 240] [--policies gaussians_based,frontier] [--object] \\
        [--dynamic] [--device cpu]

The settings are multi_scene_sweep.build_config's (quality_check's
overrides), on BoxScene.default(seed 11, 8 obstacles, a 5 m room);
QUALITY_SET="key=value,..." overrides config keys last.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import time

import numpy as np


def quality_set_opts() -> list:
    """QUALITY_SET="a.b=1,c=True" as a [KEY, VALUE, ...] override list."""
    opts = []
    for kv in os.environ.get("QUALITY_SET", "").split(","):
        if kv.strip():
            key, val = kv.split("=", 1)
            opts += [key.strip(), ast.literal_eval(val)]
    return opts


def build(policy: str, steps: int, seed: int = 11,
          frames_per_iter: int = 1, object_scene: bool = False,
          dynamic_scene: bool = False, workdir: str = "experiments/quality",
          run_name: str | None = None, scene=None, img: int = 256,
          device="cuda"):
    """(ActiveMapper, scene) at quality_check's settings."""
    from ..engine.driver import ActiveMapper
    from ..envs.fake_sim import BoxScene, FakeSim, SimObject
    from ..ops.camera import Camera
    from .multi_scene_sweep import build_config
    cfg = build_config(policy, steps, workdir, run_name or f"q_{policy}",
                       img, opts=["tpu.mapping_frames_per_iter",
                                  frames_per_iter] + quality_set_opts())
    cam = Camera(fx=img / 2.0, fy=img / 2.0, cx=img / 2.0, cy=img / 2.0,
                 width=img, height=img)
    if scene is None:
        scene = BoxScene.default(seed=seed, n_obstacles=8, room=5.0)
    obj = None
    if object_scene:
        obj = SimObject(scene, semantic_id=100, size=(0.4, 1.2, 0.4),
                        start_xz=(0.0, 1.8), seed=seed)
    sim = FakeSim(scene, cam, forward_step=0.065, turn_angle=10.0, seed=0,
                  dynamic_object=obj, object_dynamic=dynamic_scene,
                  device=device)
    mapper = ActiveMapper(cfg, sim, scene=scene, seed=0,
                          object_scene=object_scene,
                          dynamic_scene=dynamic_scene, device=device)
    return mapper, scene


def run_policy(policy: str, steps: int, frames_per_iter: int = 1,
               object_scene: bool = False, dynamic_scene: bool = False,
               device="cuda", **build_kw) -> dict:
    from ..engine.eval import accuracy_comp_ratio_from_pcl, eval_navigation
    mapper, scene = build(policy, steps, frames_per_iter=frames_per_iter,
                          object_scene=object_scene,
                          dynamic_scene=dynamic_scene, device=device,
                          **build_kw)
    gt = scene.sample_surface_points(100000)
    t0 = time.perf_counter()
    result = mapper.test_navigation(n_eval_poses=0, recon_gt_points=gt)
    wall = time.perf_counter() - t0
    mapper.metrics.dump(os.path.join(mapper.eval_dir, "metrics_curve.yaml"))
    ev = eval_navigation(mapper.slam, mapper.sim, scene, n_poses=60, seed=42)
    recon = accuracy_comp_ratio_from_pcl(mapper.global_pcl.get(), gt, 0.05,
                                         device=device)
    auc = mapper.metrics.auc("completeness_ratio")
    row = dict(policy=policy, steps=result["steps"],
               done=result["done_reason"],
               completeness=round(recon["completeness_ratio"], 2),
               acc_m=round(recon["acc_distance"], 4),
               fpr=round(recon["fpr"], 2),
               cov2d=round(result.get("coverage_2d_pct", float("nan")), 1),
               psnr=round(float(ev["psnr"]), 2),
               auc=round(float(auc), 2),
               wall_s=round(wall, 1))
    if object_scene:
        obj = mapper.sim.dynamic_object
        if obj is not None and mapper.obj_slam is not None:
            gt_obj = obj.sample_surface_points(20000, frame="object")
            m = mapper.record_object_metrics(result["steps"], gt_obj,
                                             dist_thresh=0.01)
            row["obj_completeness"] = round(m["completeness_ratio"], 2)
            row["obj_auc"] = round(float(mapper.object_metrics.auc()), 2)
        tm = result.get("timing", {}).get("object_tracking")
        if tm:
            row["object_tracking_ms"] = round(tm["mean_ms"], 1)
    row["phase_totals_s"] = {
        k: round(v["total_s"], 1) for k, v in sorted(
            result.get("timing", {}).items(),
            key=lambda kv: -kv[1]["total_s"])[:8]}
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--policies", default="gaussians_based,frontier")
    ap.add_argument("--frames_per_iter", type=int, default=1)
    ap.add_argument("--object", action="store_true",
                    help="spawn a SimObject and report the object AUC and "
                         "object_tracking ms")
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--workdir", default="experiments/quality")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = [run_policy(p.strip(), args.steps, args.frames_per_iter,
                       object_scene=args.object, dynamic_scene=args.dynamic,
                       device=args.device, workdir=args.workdir)
            for p in args.policies.split(",")]
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
