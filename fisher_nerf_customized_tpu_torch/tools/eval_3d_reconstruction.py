"""3D reconstruction metrics of an estimated cloud against a ground-truth
cloud: accuracy, completion, completeness ratio and FPR at
--dist_thresh (the JAX package's scripts/eval_3d_reconstruction.py, the
same JSON).

    python -m fisher_nerf_customized_tpu_torch.tools.eval_3d_reconstruction \\
        EST.ply GT.ply [--dist_thresh 0.05] [--device cpu]

The nearest neighbours come from engine/eval.py::_nn_dists: the 1-NN
kernel on the card from 1e8 pairs up (each distance recomputed in
float64), scipy's cKDTree below that and on the CPU.
"""
from __future__ import annotations

import argparse
import json

from ..engine.eval import accuracy_comp_ratio_from_pcl
from ..utils.pointcloud import read_ply


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("est_ply")
    p.add_argument("gt_ply")
    p.add_argument("--dist_thresh", type=float, default=0.05)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    est, gt = read_ply(args.est_ply), read_ply(args.gt_ply)
    out = accuracy_comp_ratio_from_pcl(est, gt, args.dist_thresh,
                                       device=args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
