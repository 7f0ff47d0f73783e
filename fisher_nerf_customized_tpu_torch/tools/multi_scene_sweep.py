"""Multi-scene, multi-policy sweep of completeness curves: the port's
counterpart of the JAX package's scripts/multi_scene_sweep.py (run_cell)
with scripts/quality_check.py (build).

Each (policy, scene) cell runs one episode of ActiveMapper on
BoxScene.multi_room(seed=scene_seed) at the settings of
quality_check.build: the config defaults with its overrides (256x256,
fx = fy = 128, map_every 10, 120 Adam iterations, queue 30, 256
candidates, a 5 cm map), mapper seed 0, sim seed 0, no held-out eval, the
reconstruction metric every 25 steps against cli._sample_gt's cloud.
Cells checkpoint every 100 steps and resume from their checkpoint, so a
cut run carries on.  Writes, under --out:

  metric_data/<FisherRF|FBE|RandomWalk>/fake_apartment_<seed>.yaml
      the curve in the reference's metric_data shape (a finished cell's
      YAML is its cache: it is read, not rerun);
  metric_data/auc_summary.json
      per policy the AUC mean and std over scenes, per-scene AUCs, and
      the paired FisherRF - FBE deltas with a two-sided sign test;
  cells/<policy>_fake_apartment_<seed>.json
      each run cell's result: steps, done_reason, wall seconds, the
      per-phase timer, the final recon and AUC.

    python -m fisher_nerf_customized_tpu_torch.tools.multi_scene_sweep \\
        --steps 1000 --policies gaussians_based,frontier \\
        --scene_seeds 105 --out experiments/sweep

It runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
from math import comb

import numpy as np

# the reference's policy names of the metric_data files
REF_POLICY_NAME = {
    "gaussians_based": "FisherRF",
    "frontier": "FBE",
    "random_walk": "RandomWalk",
}
DIST_THRESH = 0.05       # the recon metric's threshold (engine/driver.py)


def dump_reference_yaml(recorder, path: str, scene_id: str,
                        dist_thresh_m: float):
    """A MetricsRecorder curve in the reference's metric_data YAML shape
    (experiment, settings, steps[].{acc_distance_m, comp_distance_m,
    completeness_ratio, fpr, est_pcl_path})."""
    import yaml
    policy = recorder.header["policy"]
    steps = [dict(step=int(s["step"]),
                  acc_distance_m=float(s.get("acc_distance", 0.0)),
                  comp_distance_m=float(s.get("comp_distance", 0.0)),
                  completeness_ratio=float(s.get("completeness_ratio", 0.0)),
                  fpr=float(s.get("fpr", 0.0)),
                  est_pcl_path="None")
             for s in recorder.steps]
    doc = dict(experiment=dict(
        policy_name=REF_POLICY_NAME.get(policy, policy),
        scene_id=scene_id),
        settings=dict(distance_threshold_m=float(dist_thresh_m)),
        steps=steps)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)


def build_config(policy: str, steps: int, workdir: str, run_name: str,
                 img: int = 256, opts=None):
    """The config of quality_check.build: the defaults and its overrides;
    then `opts` [KEY, VALUE, ...] (as quality_check's QUALITY_SET)."""
    from ..config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.workdir = workdir
    cfg.run_name = run_name
    cfg.policy.name = policy
    cfg.num_frames = steps
    cfg.map_every = 10
    cfg.keyframe_every = 4
    cfg.downsample_pcd = 4
    cfg.forward_step_size = 0.065
    cfg.turn_angle = 10.0
    cfg.mapping.num_iters = 120
    cfg.mapping.prune_gaussians = True
    cfg.mapping.pruning_dict.prune_every = 40
    cfg.mapping.pruning_dict.removal_opacity_threshold = 1e-4
    cfg.policy.planning_queue_size = 30
    cfg.explore.sample_view_num = 256
    cfg.explore.cell_size = 0.05
    cfg.explore.sample_range = 1.0
    cfg.explore.min_range = 0.5
    cfg.explore.frontier_select_method = "combined"
    cfg.explore.centering = True
    cfg.H_reg_lambda = 1e-6
    cfg.path_end_weight = 30.0
    cfg.tpu.pose_chunk = 32
    cfg.tpu.mapping_frames_per_iter = 1
    if img != 256:
        cfg.img_height = cfg.img_width = img
        cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
            width=img, height=img, fx=img / 2.0, fy=img / 2.0,
            cx=img / 2.0, cy=img / 2.0))
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def run_cell(policy: str, scene_seed: int, steps: int, workdir: str,
             img: int = 256, device="cuda", opts=None) -> dict:
    """One (policy, scene) episode, resumed from its checkpoint when it
    has one: its AUC, curve recorder, wall seconds and result."""
    from ..cli import _sample_gt
    from ..engine.driver import ActiveMapper
    from ..envs.fake_sim import BoxScene, FakeSim
    from ..ops.camera import Camera
    scene = BoxScene.multi_room(seed=scene_seed)
    scene_id = f"fake_apartment_{scene_seed}"
    cfg = build_config(policy, steps, workdir, f"{policy}_{scene_id}", img,
                       opts)
    cam = Camera(fx=img / 2.0, fy=img / 2.0, cx=img / 2.0, cy=img / 2.0,
                 width=img, height=img)
    sim = FakeSim(scene, cam, forward_step=0.065, turn_angle=10.0, seed=0,
                  device=device)
    mapper = ActiveMapper(cfg, sim, scene=scene, seed=0, scene_id=scene_id,
                          device=device)
    mapper.checkpoint_interval = 100
    cks = glob.glob(os.path.join(mapper.eval_dir, "params*.npz"))
    if cks and os.path.exists(os.path.join(mapper.eval_dir,
                                           "episode_state.npz")):
        mapper.resume(max(cks, key=os.path.getmtime))
    gt = _sample_gt(scene)
    t0 = time.perf_counter()
    result = mapper.test_navigation(n_eval_poses=0, recon_gt_points=gt)
    wall = time.perf_counter() - t0
    auc = float(mapper.metrics.auc("completeness_ratio"))
    return dict(auc=auc, recorder=mapper.metrics, wall_s=wall,
                result=result, scene_id=scene_id)


def summarize(acc: dict, steps: int, seeds) -> dict:
    """AUC mean and std per policy, per-scene AUCs, and the paired
    FisherRF - FBE comparison (per-scene deltas, two-sided sign test)."""
    summary = {"steps": steps, "n_scenes": len(seeds),
               "scene_seeds": list(seeds), "policies": {}}
    for policy, a in acc.items():
        if not a["aucs"]:
            continue
        summary["policies"][REF_POLICY_NAME.get(policy, policy)] = dict(
            n_scenes_done=len(a["aucs"]),
            auc_mean=float(np.mean(a["aucs"])),
            auc_std=float(np.std(a["aucs"])),
            auc_per_scene={f"fake_apartment_{s}": round(v, 3)
                           for s, v in zip(a["seeds"], a["aucs"])},
            wall_s_total=round(float(np.sum(a["walls"])), 1))
    pols = summary["policies"]
    if "FisherRF" in pols and "FBE" in pols:
        a, b = pols["FisherRF"]["auc_per_scene"], pols["FBE"]["auc_per_scene"]
        deltas = {s: round(a[s] - b[s], 3) for s in sorted(set(a) & set(b))}
        wins = sum(1 for d in deltas.values() if d > 0)
        n = sum(1 for d in deltas.values() if d != 0)
        p_sign = (min(1.0, 2.0 * sum(comb(n, k) for k in
                                     range(min(wins, n - wins) + 1))
                      / (2.0 ** n)) if n else 1.0)
        summary["paired_FisherRF_vs_FBE"] = dict(
            per_scene_delta=deltas,
            mean_delta=round(float(np.mean(list(deltas.values()))), 3)
            if deltas else 0.0,
            wins=wins, n_nonzero=n, sign_test_p=round(p_sign, 4))
    return summary


def main(argv=None):
    import yaml
    from ..cli import literal_overrides
    from ..engine.eval import trapezoid_auc
    ap = argparse.ArgumentParser("multi_scene_sweep")
    ap.add_argument("--policies", default="gaussians_based,frontier")
    ap.add_argument("--scene_seeds", default="105",
                    help="comma-separated scene seeds")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default="experiments/sweep")
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the episodes (cuda unless asked)")
    ap.add_argument("--set", dest="opts", nargs="*", default=None,
                    action="append", metavar="KEY VALUE",
                    help="config overrides applied last: KEY VALUE "
                         "[KEY VALUE ...] (dotted keys; the flag may repeat)")
    args = ap.parse_args(argv)
    opts = literal_overrides(args.opts) if args.opts else None

    policies = [p.strip() for p in args.policies.split(",") if p.strip()]
    seeds = [int(s) for s in args.scene_seeds.split(",") if s.strip()]
    md_dir = os.path.join(args.out, "metric_data")
    cell_dir = os.path.join(args.out, "cells")
    os.makedirs(md_dir, exist_ok=True)
    os.makedirs(cell_dir, exist_ok=True)
    acc = {p: dict(aucs=[], walls=[], seeds=[]) for p in policies}
    # scene-major: both policies of a scene run back to back, so a cut
    # sweep leaves whole pairs
    for seed in seeds:
        for policy in policies:
            scene_id = f"fake_apartment_{seed}"
            ypath = os.path.join(md_dir, REF_POLICY_NAME.get(policy, policy),
                                 f"{scene_id}.yaml")
            if os.path.exists(ypath):
                with open(ypath) as f:
                    doc = yaml.safe_load(f)
                auc = trapezoid_auc([s["completeness_ratio"]
                                     for s in doc["steps"]])
                print(json.dumps(dict(policy=policy, scene=scene_id,
                                      auc=round(auc, 3), cached=True)),
                      flush=True)
                acc[policy]["aucs"].append(auc)
                acc[policy]["walls"].append(0.0)
                acc[policy]["seeds"].append(seed)
                continue
            cell = run_cell(policy, seed, args.steps,
                            os.path.join(args.out, "runs"),
                            img=args.img, device=args.device, opts=opts)
            dump_reference_yaml(cell["recorder"], ypath, scene_id,
                                DIST_THRESH)
            res = cell["result"]
            row = dict(policy=policy, scene=scene_id, auc=cell["auc"],
                       steps=res["steps"], done=res["done_reason"],
                       wall_s=cell["wall_s"])
            with open(os.path.join(cell_dir, f"{policy}_{scene_id}.json"),
                      "w") as f:
                json.dump(dict(row, result=res), f, indent=1, default=float)
            print(json.dumps(row), flush=True)
            acc[policy]["aucs"].append(cell["auc"])
            acc[policy]["walls"].append(cell["wall_s"])
            acc[policy]["seeds"].append(seed)
    summary = summarize(acc, args.steps, seeds)
    with open(os.path.join(md_dir, "auc_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"summary": {
        k: dict(auc_mean=round(v["auc_mean"], 3),
                auc_std=round(v["auc_std"], 3))
        for k, v in summary["policies"].items()},
        "paired": summary.get("paired_FisherRF_vs_FBE")}), flush=True)
    return summary


if __name__ == "__main__":
    main()
