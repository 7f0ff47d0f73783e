"""The system under test: the PyTorch port's episode objects, built from a
configuration file of the benchmark (its settings, image size, scene and
overrides), and the port's own counters and hooks that the cells read."""
from __future__ import annotations

import os

PORT = "fisher_nerf_customized_tpu_torch"


def build_cfg(config: dict, workdir: str, run_name: str):
    """The port's config: its defaults, the configuration's settings (the
    YAML it was taken from, copied into the file), the camera at
    `img_size`, then the `overrides`."""
    from fisher_nerf_customized_tpu_torch.cli import literal_overrides
    from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.merge_from_other(config["settings"])
    cfg.workdir = workdir
    cfg.run_name = run_name
    size = config.get("img_size")
    if size:
        cfg.img_height = cfg.img_width = size
        cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
            width=size, height=size, fx=size / 2, fy=size / 2, cx=size / 2,
            cy=size / 2))
    over = config.get("overrides") or {}
    if over:
        flat = [[k, repr(v)] for k, v in over.items()]
        cfg.merge_from_list(literal_overrides(flat))
    return cfg


def build_episode(run, workdir: str, with_gt: bool = True):
    """(mapper, sim, scene, gt_points) of one episode of the cell's
    configuration on its scene, the agent's streams seeded by --seed, as
    the port's entry point (cli.run_scene) builds them; gt_points None
    without `with_gt`."""
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.engine.driver import ActiveMapper
    conf = run.config
    cfg = build_cfg(conf, workdir, run.cell)
    args = cli.build_parser().parse_args(
        ["--device", run.device, "--seed", str(run.seed)])
    scene_id = conf["scene"]
    with run.setup_part("scene_and_gt"):
        sim, scene = cli.make_sim(args, cfg, scene_id)
        gt = cli._sample_gt(scene) if with_gt else None
    mapper = ActiveMapper(cfg, sim, scene=scene,
                          eval_dir=os.path.join(workdir, scene_id),
                          seed=run.seed, scene_id=scene_id,
                          device=run.device)
    return mapper, sim, scene, gt


def camera_of(cam):
    """The reference's camera for one of the port's cameras."""
    from reference.gaussians import Camera
    return Camera(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                  cy=float(cam.cy), width=int(cam.width),
                  height=int(cam.height), near=float(cam.near),
                  dilation=float(cam.dilation))


def load_kernels(device: str):
    """Build (a checkout's first run) or load every CUDA kernel of the
    port, so that no build falls inside a window."""
    if device == "cpu":
        return
    from fisher_nerf_customized_tpu_torch.ops import cuda_build
    cuda_build.build_all()
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
