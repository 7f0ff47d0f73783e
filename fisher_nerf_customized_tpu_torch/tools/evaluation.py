"""Coverage of a run's latest point cloud: its
pointcloud/global_pcl_<t>.ply against a ground-truth surface cloud, the
5 cm coverage percentage and the reconstruction metrics (the JAX
package's scripts/evaluation.py, the same JSON).

    python -m fisher_nerf_customized_tpu_torch.tools.evaluation RUN_DIR \\
        [--gt_ply GT.ply | --gt_glb SCENE.glb | --fake_scene_seed N] \\
        [--n_gt_points 400000] [--dist_thresh 0.05] [--device cpu]

The ground truth is a PLY cloud, a .glb mesh sampled with trimesh (which
must then be installed), or else FakeSim's BoxScene.default(seed)
sampled at --n_gt_points.  The nearest neighbours: engine/eval.py::
_nn_dists (the 1-NN kernel on the card from 1e8 pairs up).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np

from ..engine.eval import accuracy_comp_ratio_from_pcl, coverage_percentage
from ..utils.pointcloud import read_ply


def get_latest_pcl_file(run_dir: str):
    """(path, step) of the run's pointcloud/global_pcl_<step>.ply with the
    largest step, or (None, -1)."""
    files = glob.glob(os.path.join(run_dir, "pointcloud", "global_pcl_*.ply"))
    best, best_t = None, -1
    for f in files:
        m = re.search(r"global_pcl_(\d+)\.ply", f)
        if m and int(m.group(1)) > best_t:
            best, best_t = f, int(m.group(1))
    return best, best_t


def load_gt_points(args) -> np.ndarray:
    if args.gt_ply:
        return read_ply(args.gt_ply)
    if args.gt_glb:
        try:
            import trimesh
        except ImportError:
            raise SystemExit(".glb ground truth needs trimesh (not "
                             "installed); use --gt_ply or --fake_scene_seed")
        mesh = trimesh.load(args.gt_glb, force="mesh")
        pts, _ = trimesh.sample.sample_surface(mesh, args.n_gt_points)
        return np.asarray(pts, np.float32)
    from ..envs.fake_sim import BoxScene
    scene = BoxScene.default(seed=args.fake_scene_seed)
    return scene.sample_surface_points(args.n_gt_points)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("run_dir", help="experiment dir containing pointcloud/")
    p.add_argument("--gt_ply", default=None)
    p.add_argument("--gt_glb", default=None)
    p.add_argument("--fake_scene_seed", type=int, default=0)
    p.add_argument("--n_gt_points", type=int, default=400000)
    p.add_argument("--dist_thresh", type=float, default=0.05)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    pcl_file, t = get_latest_pcl_file(args.run_dir)
    if pcl_file is None:
        raise SystemExit(f"no pointcloud/global_pcl_*.ply under {args.run_dir}")
    est = read_ply(pcl_file)
    gt = load_gt_points(args)
    cov = coverage_percentage(gt, est, args.dist_thresh)
    recon = accuracy_comp_ratio_from_pcl(est, gt, args.dist_thresh,
                                         device=args.device)
    out = dict(pcl_file=pcl_file, step=t, n_est=len(est), n_gt=len(gt),
               coverage_pct=cov, **recon)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
