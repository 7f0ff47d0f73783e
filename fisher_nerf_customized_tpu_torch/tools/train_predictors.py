"""Train UPEN's occupancy-predictor ensemble on recorded episodes.

Counterpart of the JAX package's scripts/train_predictors.py, with its
flags and its JSON line:

    python -m fisher_nerf_customized_tpu_torch.tools.train_predictors \\
        --out_dir experiments/predictors --n_scenes 4 --steps_per_scene 40

The episodes are recorded on FakeSim (envs/offline_dataset.py, saved as
<out_dir>/offline_dataset.npz) unless --dataset_npz names an archive;
the last fifth is held out.  The ensemble (seeded by --seed, each member
on its bootstrap subset) is trained on the card unless `--device cpu`,
saved as <out_dir>/member_<i>.pkl (the JAX package's format: either
package loads the other's) and scored by mean IoU on the held-out
samples.  Prints one JSON line: final_losses, val_miou, n_train, n_val,
out_dir.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_predictors")
    p.add_argument("--out_dir", default="experiments/predictors")
    p.add_argument("--dataset_npz", default=None,
                   help="pre-stored (inputs, labels) archive")
    p.add_argument("--n_scenes", type=int, default=4)
    p.add_argument("--steps_per_scene", type=int, default=40)
    p.add_argument("--grid_dim", type=int, default=64)
    p.add_argument("--ensemble_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dataset_percentage", type=float, default=0.9)
    p.add_argument("--traj_policy", default="frontier",
                   choices=("frontier", "random"),
                   help="recording policy of the episodes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless asked)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..engine.seg_metrics import mean_iou
    from ..envs.offline_dataset import (generate_offline_dataset,
                                        load_dataset, save_dataset)
    from ..models.predictors import PredictorEnsemble
    from ..ops.camera import Camera

    if args.dataset_npz and os.path.exists(args.dataset_npz):
        inputs, labels = load_dataset(args.dataset_npz)
    else:
        cam = Camera(fx=64.0, fy=64.0, cx=64.0, cy=64.0, width=128,
                     height=128)
        inputs, labels = generate_offline_dataset(
            cam, n_scenes=args.n_scenes,
            steps_per_scene=args.steps_per_scene, grid_dim=args.grid_dim,
            seed=args.seed, traj_policy=args.traj_policy,
            device=args.device)
        save_dataset(os.path.join(args.out_dir, "offline_dataset.npz"),
                     inputs, labels)

    n_val = max(len(inputs) // 5, 1)
    tr_x, tr_y = inputs[:-n_val], labels[:-n_val]
    va_x, va_y = inputs[-n_val:], labels[-n_val:]

    ens = PredictorEnsemble(n_members=args.ensemble_size, seed=args.seed,
                            device=args.device)
    losses = ens.train(tr_x, tr_y, epochs=args.epochs,
                       batch_size=args.batch_size,
                       dataset_percentage=args.dataset_percentage,
                       seed=args.seed)
    ens.save(args.out_dir)

    mean, _var, _ = ens.predict(va_x)
    pred = mean.cpu().numpy().argmax(-1)
    out = dict(final_losses=[float(v) for v in losses],
               val_miou=mean_iou(pred, va_y, 3), n_train=len(tr_x),
               n_val=len(va_x), out_dir=args.out_dir)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
