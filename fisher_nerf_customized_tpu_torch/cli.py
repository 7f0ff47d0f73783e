"""Command-line entry point of the PyTorch port: one active-mapping
episode per scene, on the hermetic FakeSim or on habitat-sim, one JSON
line per scene.

    python -m fisher_nerf_customized_tpu_torch \\
        --slam_config configs/mp3d_gaussian_FR_eccv.yaml \\
        --scenes_list fake_apartment_0 --max_steps 100

The flags are the JAX package's (cli.py); the episode runs on the card
unless `--device cpu` is given.  Scene ids: `fake_apartment_<n>` (3x3
rooms) or `fake_apartment<X>x<Z>_<n>` (X x Z rooms), any other id a
single box room; the scene's seed is the crc32 of its id.  After the
episode, as in the JAX package: the map is evaluated over `--eval_poses`
held-out poses (2000 by default; 0 skips it), the reconstruction metric
runs against a ground-truth cloud of the scene's surfaces, and
<log_dir>/<name>/<scene_id>/ gets the checkpoint (params<steps>.npz,
keyframes.npz, astar.npz, global_pcl.npz, episode_rng.pkl,
episode_state.npz), pointcloud/global_pcl_<steps>.ply,
recon_metrics.yaml, metrics_curve.yaml, eval.json,
<policy>_results.txt, eval_psnr_map.png and result.json.  `--resume
--checkpoint <params file>` continues an episode from its checkpoint.
`--object_scene` spawns a 0.4 x 1.2 x 0.4 m SimObject at (0, 1.8), or at
a navigable point drawn from the scene's seed where that is not
navigable, and runs the object branch (cfg.criterion: fisher, topt or
dopt); `--dynamic_scene` makes it random-walk; the object's curve goes
to object_metrics_curve.yaml.  `--known_env` runs the known-environment
mode: the planner's map is seeded from 400 000 points of the scene's
surfaces without the object, and the episode plans by coverage; with
`--object_scene` the object is found by novelty against that cloud
(pixels more than 5 cm from it) instead of by its semantic label.

`--policy UPEN_fbe` (or configs/mp3d_gaussian_UPEN_fbe.yaml) and
`UPEN_rrt` run the UPEN baseline; `--ensemble_dir DIR` loads its
ensemble from DIR/member_<i>.pkl (tools/train_predictors.py's output,
or the JAX package's; cfg.policy.ensemble_dir), else the ensemble is
untrained.  `--dino_gate` gates object mapping by the distinctiveness
of each object frame's patch descriptors (engine/dino_gate.py).
`--dino_weights PATH` (a DINO / DINOv2 ViT torch checkpoint) gates with
the ViT's patch descriptors instead (models/perceptual.py; it implies
the gate on the object branch).  `--set policy.save_nav_images True`
writes the planning and top-down PNGs.  `--lpips_weights PATH` (an
LPIPS(alex) torch checkpoint) adds the real LPIPS(alex), `lpips`, to the
evaluation beside lpips_proxy.

`--sim habitat` runs the scenes on habitat-sim (envs/habitat_adapter.py:
habitat-lab and habitat-sim must be installed, with the scenes under
`data/` as the reference lays them out; `--dataset MP3D`, `gibson`,
`hm3d`, `replica` or `habitat_test_scenes`).  Its scene has no
ground-truth cloud, so the reconstruction metric and `--known_env` are
skipped; with --object_scene it spawns habitat's wheeled_robot.

The frontier-only pipeline (no Gaussian map, FBE goals, the planner's
paths): `python -m fisher_nerf_customized_tpu_torch.main_navigation`
with the same flags (main_navigation below); it writes
pointcloud/global_pcl_<steps>.ply and result.json.

The repository holds no LPIPS or ViT weights and no habitat-sim: those
three flags need files and packages from elsewhere.

Under torchrun (or SLURM) the entry points join the process group first
(parallel/distributed.py); with `--set tpu.mesh_axes.data N` on N ranks
the episode's mapping event, pose scores, H_train and path EIG split
over the ranks, and only rank 0 writes files:

    torchrun --nproc_per_node N -m fisher_nerf_customized_tpu_torch \\
        --slam_config configs/mp3d_gaussian_FR_eccv.yaml \\
        --scenes_list fake_apartment_0 --set tpu.mesh_axes.data N
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import re
import zlib

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("fisher_nerf_customized_tpu_torch")
    req = p.add_argument_group("Required")
    req.add_argument("--name", default="test_pointnav_exp")
    req.add_argument("--slam_config", type=str, default=None,
                     help="experiment YAML (reference-format keys)")
    req.add_argument("--dataset", type=str, default="fake",
                     help="mp3d | hm3d | gibson | fake")
    req.add_argument("--dataset_split", type=str, default="val")
    p.add_argument("--scenes_list", nargs="+", default=["fake_room_0"])
    p.add_argument("--sim", type=str, default="fake",
                   choices=["fake", "habitat"])
    p.add_argument("--policy", type=str, default=None,
                   help="override cfg.policy.name")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--img_size", type=int, default=None)
    p.add_argument("--log_dir", default="experiments/logs")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true",
                   help="cap num_frames at 40 and mapping iterations at 10")
    # held-out poses of the evaluation after the episode (0 skips it)
    p.add_argument("--eval_poses", type=int, default=2000)
    p.add_argument("--eval_every", type=int, default=None,
                   help="record a held-out PSNR/depth-MAE curve on a "
                        "fixed pose set every N steps (cfg.eval_every)")
    p.add_argument("--save_data", action="store_true")
    p.add_argument("--ensemble_dir", default=None,
                   help="trained UPEN ensemble (member_<i>.pkl files); "
                        "overrides policy.ensemble_dir")
    p.add_argument("--object_scene", action="store_true")
    p.add_argument("--dynamic_scene", action="store_true")
    p.add_argument("--known_env", action="store_true")
    p.add_argument("--lpips_weights", default=None,
                   help="LPIPS(alex) torch checkpoint: the real `lpips` "
                        "beside lpips_proxy in the evaluation")
    p.add_argument("--dino_gate", action="store_true",
                   help="gate object mapping by descriptor "
                        "distinctiveness (histogram descriptors)")
    p.add_argument("--dino_weights", default=None,
                   help="DINO / DINOv2 ViT torch checkpoint for the object "
                        "gate (implies --dino_gate)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the episode (cuda unless asked)")
    p.add_argument("--set", dest="opts", nargs="*", default=None,
                   action="append", metavar="KEY VALUE",
                   help="config overrides applied last: KEY VALUE "
                        "[KEY VALUE ...] (dotted keys; the flag may repeat)")
    return p


def load_config(args):
    from .config import get_cfg_defaults
    cfg = get_cfg_defaults()
    if args.slam_config:
        cfg.merge_from_file(args.slam_config)
    if args.log_dir:
        cfg.workdir = args.log_dir
    if args.name:
        cfg.run_name = args.name
    if args.policy:
        cfg.policy.name = args.policy
    if args.max_steps is not None:
        cfg.num_frames = args.max_steps
    if args.img_size is not None:
        cfg.img_height = cfg.img_width = args.img_size
        cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
            width=args.img_size, height=args.img_size,
            fx=args.img_size / 2, fy=args.img_size / 2,
            cx=args.img_size / 2, cy=args.img_size / 2))
    if args.eval_every is not None:
        cfg.eval_every = int(args.eval_every)
    if args.ensemble_dir:
        cfg.policy.ensemble_dir = args.ensemble_dir
    if args.debug:
        cfg.mapping.num_iters = min(int(cfg.mapping.num_iters), 10)
        cfg.num_frames = min(int(cfg.num_frames), 40)
    if args.opts:
        cfg.merge_from_list(literal_overrides(args.opts))
    return cfg


def literal_overrides(groups) -> list:
    """`--set` groups [[KEY, VALUE, ...], ...] as one KEY, VALUE list, each
    VALUE through ast.literal_eval where it parses (else a string)."""
    flat = [v for group in groups for v in group]
    vals = []
    for i, v in enumerate(flat):
        if i % 2 == 1:
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass
        vals.append(v)
    return vals


def _sample_gt(scene, density_per_m2: float = 2000.0):
    """Ground-truth surface cloud of 2000 points per m² of the scene's
    faces, clipped to 100 000 - 1 200 000 points (about 2.2 cm between
    neighbours, well under the 5 cm threshold); 400 000 points of a scene
    that does not know its area, and None from one without a cloud
    (HabitatScene)."""
    if hasattr(scene, "surface_area"):
        n = int(np.clip(scene.surface_area() * density_per_m2,
                        100_000, 1_200_000))
    else:
        n = 400_000
    return scene.sample_surface_points(n)


def make_sim(args, cfg, scene_id: str):
    """The simulator and its scene for a scene id.  With --sim habitat, a
    HabitatSim and its HabitatScene (with --object_scene, habitat's
    wheeled_robot under <root_path>/habitat_example_objects_0.2, scaled
    0.3, at a random navigable point).  Else FakeSim and its BoxScene:
    `fake_apartment*` ids the multi-room generator
    (`fake_apartment<X>x<Z>` sets the grid of rooms, 3x3 by default), any
    other id the single-room default; the scene's seed is the crc32 of
    the id (stable across processes).  With --object_scene, the scene
    holds a SimObject (see the module docstring), moved by the episode
    with --dynamic_scene."""
    if args.sim == "habitat":
        from .envs.habitat_adapter import HabitatScene, HabitatSim
        hsim = HabitatSim(args, cfg, scene_id, device=args.device)
        if args.object_scene:
            hsim.spawn_object(os.path.join(
                str(getattr(args, "root_path", "data")),
                "habitat_example_objects_0.2/wheeled_robot"),
                scale=0.3, semantic_id=100)
        return hsim, HabitatScene(hsim)
    from .envs.fake_sim import BoxScene, FakeSim, SimObject
    from .ops.camera import Camera
    calib = cfg.SLAM.Dataset.Calibration
    cam = Camera(fx=float(calib.fx), fy=float(calib.fy),
                 cx=float(calib.cx), cy=float(calib.cy),
                 width=int(calib.width), height=int(calib.height))
    seed = zlib.crc32(scene_id.encode()) % (2 ** 31)
    if scene_id.startswith("fake_apartment"):
        m = re.match(r"fake_apartment(\d+)x(\d+)", scene_id)
        rx, rz = (int(m.group(1)), int(m.group(2))) if m else (3, 3)
        scene = BoxScene.multi_room(seed=seed, rooms_x=rx, rooms_z=rz)
    else:
        scene = BoxScene.default(seed=seed)
    obj = None
    if args.object_scene:
        start = (0.0, 1.8)
        if not scene.is_navigable((start[0], 0.0, start[1])):
            start = tuple(scene.sample_navigable(
                np.random.default_rng(seed), 1)[0])
        obj = SimObject(scene, semantic_id=100, size=(0.4, 1.2, 0.4),
                        start_xz=start, seed=seed)
    sim = FakeSim(scene, cam, forward_step=float(cfg.forward_step_size),
                  turn_angle=float(cfg.turn_angle), seed=args.seed,
                  dynamic_object=obj, device=args.device,
                  object_dynamic=bool(args.dynamic_scene))
    return sim, scene


def known_env_points(scene):
    """The known environment's cloud: 400 000 points of the scene's room
    shells and obstacles, without the object; None for a scene without
    boxes (HabitatScene), as in the JAX package."""
    from .envs.fake_sim import BoxScene
    if not hasattr(scene, "room_lo"):
        return None
    empty = BoxScene(room_lo=scene.room_lo, room_hi=scene.room_hi,
                     obstacles=scene.obstacles)
    return empty.sample_surface_points(400000)


def run_scene(args, cfg, scene_id: str):
    """One episode on one scene: (result dict, the ActiveMapper).  With
    --resume and --checkpoint the episode continues from its checkpoint.
    After the episode it writes, under <log_dir>/<name>/<scene_id>/, the
    checkpoint at the last step, pointcloud/global_pcl_<steps>.ply,
    recon_metrics.yaml and result.json."""
    from .engine.driver import ActiveMapper
    sim, scene = make_sim(args, cfg, scene_id)
    eval_dir = os.path.join(cfg.workdir, cfg.run_name, scene_id)
    mapper = ActiveMapper(cfg, sim, scene=scene, eval_dir=eval_dir,
                          seed=args.seed, scene_id=scene_id,
                          object_scene=args.object_scene,
                          dynamic_scene=args.dynamic_scene,
                          known_env_points=(known_env_points(scene)
                                            if args.known_env else None),
                          device=args.device, dino_gate=args.dino_gate,
                          dino_weights=args.dino_weights)
    if args.resume and args.checkpoint:
        mapper.resume(args.checkpoint)
    gt = _sample_gt(scene)
    result = mapper.test_navigation(n_eval_poses=args.eval_poses,
                                    recon_gt_points=gt)
    steps = result["steps"]
    # the loop ended before step `steps`, with the sim at its pose: a
    # resume continues there
    mapper.save_checkpoint(steps, sim_c2w=sim.c2w, resume_t=steps)
    if mapper.writer:
        mapper.global_pcl.save_ply(os.path.join(
            eval_dir, "pointcloud", f"global_pcl_{steps}.ply"))
        mapper.metrics.dump(os.path.join(eval_dir, "recon_metrics.yaml"))
        with open(os.path.join(eval_dir, "result.json"), "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result, mapper


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = load_config(args)
    # the process group under torchrun or SLURM (a no-op in one process)
    from .parallel.distributed import init_distributed
    init_distributed(device=args.device)
    from .engine.eval import set_lpips_weights
    set_lpips_weights(args.lpips_weights)
    results = {}
    for scene_id in args.scenes_list:
        result, _mapper = run_scene(args, cfg, scene_id)
        results[scene_id] = result
        print(json.dumps({scene_id: result}, default=float), flush=True)
    return results


def run_navigation(args, cfg, scene_id: str):
    """One frontier-only episode (engine/navigator.py) on one scene:
    (result dict, the FrontierNavigator).  Writes, under
    <log_dir>/<name>/<scene_id>/, pointcloud/global_pcl_<steps>.ply and
    result.json."""
    from .engine.navigator import FrontierNavigator
    sim, scene = make_sim(args, cfg, scene_id)
    eval_dir = os.path.join(cfg.workdir, cfg.run_name, scene_id)
    nav = FrontierNavigator(cfg, sim, scene=scene, eval_dir=eval_dir,
                            seed=args.seed, device=args.device)
    result = nav.frontier_test_navigation(recon_gt_points=_sample_gt(scene))
    from .parallel.distributed import is_writer
    if is_writer():
        nav.global_pcl.save_ply(os.path.join(
            eval_dir, "pointcloud", f"global_pcl_{result['steps']}.ply"))
        with open(os.path.join(eval_dir, "result.json"), "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result, nav


def main_navigation(argv=None):
    """The frontier-only pipeline, one JSON line per scene."""
    args = build_parser().parse_args(argv)
    cfg = load_config(args)
    from .parallel.distributed import init_distributed
    init_distributed(device=args.device)
    results = {}
    for scene_id in args.scenes_list:
        result, _nav = run_navigation(args, cfg, scene_id)
        results[scene_id] = result
        print(json.dumps({scene_id: result}, default=float), flush=True)
    return results
