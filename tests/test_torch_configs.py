"""The four FakeSim experiment configs, JAX package against the PyTorch
port on the CPU.

  - The merged trees of configs/mp3d_gaussian_FR_eccv.yaml,
    FR_eccv_gaussians.yaml, FR_frontier.yaml and UPEN_fbe.yaml through
    each package's cli.load_config, with and without `--img_size 800`,
    are equal on every key both trees hold.  `img_height: 800` in a YAML
    does not reach SLAM.Dataset.Calibration in either package: only
    `--img_size` sets the camera (fx = fy = size / 2).
  - One episode per config no port test ran before, through each
    package's load_config and make_sim on fake_apartment_0 (FakeSim seed
    0, mapper seed 0), with that config's own settings and only depth
    and width cut: FR_eccv_gaussians (FBE at the eccv operating point) at
    48x48 for 26 steps with capacity 8192; FR_frontier (800x800 FBE at
    0.05 m and 5 degrees, queue 30, sil loss off, pruning every 40 from
    step 0) at 96x96 for 60 steps with `tpu.capacity 512` and
    `tpu.tile_size 8`, so that the map grows through _ensure_capacity
    at least twice and pruning runs.  The JAX sim hands out host frames
    (device_obs=False), so that its point cloud takes the numpy stream
    the port reproduces.

Each pair must take the same actions, stop at the same step for the same
reason, cover the same cells (1e-9), grow the map through the same slot
capacities, agree on the recon curve to rtol 1e-6 and on the evaluation
over 8 held-out poses within test_torch_episode.py's tolerances.

The Gaussian count is held to rtol 5e-3, not exactly.  Adam runs with
eps = 1e-15, so a coordinate whose gradient sits at the f32 noise floor
moves by lr a step in the gradient's sign in either package, and the
two can part by up to 2 lr a step (test_torch_mapping.py's reason).  At
FR_frontier's 60 iterations an event, a tail of the map (about a tenth
of the Gaussians by more than 1e-3) parts that way while the median
coordinate agrees to 1e-6; a pixel whose silhouette then sits on either
side of sil_thres 0.5 changes the next densify's candidates by one (on
fake_apartment_0 at 96x96: 1305 Gaussians in the JAX package, 1306 in
the port after 60 steps, from the event at step 19 on).
"""
import os

import numpy as np
import pytest
import torch
import yaml

from fisher_nerf_customized_tpu import cli as jcli
from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu_torch import cli as tcli
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.models import slam as tslam

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
YAMLS = ["mp3d_gaussian_FR_eccv.yaml", "mp3d_gaussian_FR_eccv_gaussians.yaml",
         "mp3d_gaussian_FR_frontier.yaml", "mp3d_gaussian_UPEN_fbe.yaml"]
SCENE = "fake_apartment_0"
EVAL_POSES = 8
N_RTOL = 5e-3              # Gaussian count (see the module docstring)
# (config, image size, steps, overrides): only depth and width are cut
EPISODES = {
    "FR_eccv_gaussians": ("mp3d_gaussian_FR_eccv_gaussians.yaml", 48, 26,
                          ["tpu.capacity", "8192"]),
    "FR_frontier": ("mp3d_gaussian_FR_frontier.yaml", 96, 60,
                    ["tpu.capacity", "512", "tpu.tile_size", "8"]),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the suite's six workers
    share the CPU beside XLA's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(cli, argv):
    args = cli.build_parser().parse_args(argv)
    return args, cli.load_config(args)


def shared_differences(ref: dict, got: dict, prefix="") -> list:
    """Keys both trees hold whose values differ (recursing into nodes)."""
    out = []
    for k in sorted(set(ref) & set(got)):
        r, g = ref[k], got[k]
        if isinstance(r, dict) and isinstance(g, dict):
            out += shared_differences(r, g, f"{prefix}{k}.")
        elif r != g:
            out.append((f"{prefix}{k}", r, g))
    return out


@pytest.mark.parametrize("img_size", [None, 800])
@pytest.mark.parametrize("name", YAMLS)
def test_merged_trees_match(name, img_size, tmp_path):
    argv = ["--slam_config", os.path.join(CONFIGS, name),
            "--log_dir", str(tmp_path)]
    if img_size:
        argv += ["--img_size", str(img_size)]
    _a, ref = load(jcli, argv)
    _a, got = load(tcli, argv)
    ref, got = ref.to_dict(), got.to_dict()
    assert shared_differences(ref, got) == []
    # every key of the port's tree outside its own `tpu` additions is the
    # JAX package's
    missing = sorted(set(ref) ^ set(got))
    assert missing == [], missing
    calib = got["SLAM"]["Dataset"]["Calibration"]
    with open(os.path.join(CONFIGS, name)) as f:
        yaml_img = yaml.safe_load(f).get("img_height")
    if img_size:
        assert (calib["width"], calib["height"]) == (img_size, img_size)
        assert calib["fx"] == calib["fy"] == img_size / 2
        assert got["img_height"] == got["img_width"] == img_size
    else:
        # the YAML's img_height (800 in FR_frontier) leaves the camera at
        # the defaults' in both packages
        assert got["img_height"] == yaml_img
        assert (calib["width"], calib["height"]) == (
            ref["SLAM"]["Dataset"]["Calibration"]["width"],
            ref["SLAM"]["Dataset"]["Calibration"]["height"])
        if yaml_img == 800:
            assert calib["width"] != 800


def run(pkg, tmp, key, monkeypatch):
    """One episode of EPISODES[key]: (result, actions, mapper, the map's
    slot capacities after each step, and in the port the slots each
    mapping event's compaction released)."""
    name, img, steps, sets = EPISODES[key]
    argv = ["--slam_config", os.path.join(CONFIGS, name),
            "--img_size", str(img), "--max_steps", str(steps),
            "--log_dir", str(tmp / pkg), "--name", key,
            "--scenes_list", SCENE, "--set"] + sets
    compactions = []
    if pkg == "jax":
        args, cfg = load(jcli, argv)
        sim, scene = jcli.make_sim(args, cfg, SCENE)
        sim.device_obs = False
        drv, kw = jdriver, {}
    else:
        args, cfg = load(tcli, argv + ["--device", "cpu"])
        sim, scene = tcli.make_sim(args, cfg, SCENE)
        drv, kw = tdriver, dict(device="cpu")
        compact = tslam.prune_compact

        def counted(state, keep):
            compactions.append(int(state.n_active - keep.sum()))
            return compact(state, keep)

        monkeypatch.setattr(tslam, "prune_compact", counted)
    actions, capacities = [], []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    mapper = drv.ActiveMapper(
        cfg, sim, scene=scene, seed=0,
        eval_dir=os.path.join(cfg.workdir, cfg.run_name, SCENE), **kw)

    def on_step(_t, _obs):
        capacities.append(int(mapper.slam.state.capacity))

    result = mapper.test_navigation(
        n_eval_poses=EVAL_POSES,
        recon_gt_points=scene.sample_surface_points(4000), on_step=on_step)
    return result, actions, mapper, capacities, compactions


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    made = {}

    def get(key):
        if key not in made:
            tmp = tmp_path_factory.mktemp(key)
            with pytest.MonkeyPatch.context() as mp:
                made[key] = (key, run("jax", tmp, key, mp),
                             run("torch", tmp, key, mp))
        return made[key]

    return get


@pytest.fixture(params=sorted(EPISODES))
def episodes(request, runs):
    return runs(request.param)


def test_same_actions_and_end(episodes):
    key, (jres, ja, _jm, _jc, _jp), (tres, ta, _tm, _tc, _tp) = episodes
    steps = EPISODES[key][2]
    assert ta == ja
    assert len(ja) == jres["steps"] == tres["steps"] == steps
    assert tres["done_reason"] == jres["done_reason"] == "max_steps"
    if key == "FR_frontier":
        # the init scan: int(90 // 5) = 18 turns left
        assert ja[:18] == [2] * 18


def test_coverage_map_and_capacity(episodes):
    key, (jres, _ja, jm, jcap, _jp), (tres, _ta, tm, tcap, tpruned) = \
        episodes
    assert tres["coverage_2d_pct"] == pytest.approx(
        jres["coverage_2d_pct"], abs=1e-9)
    assert tcap == jcap
    for got, ref in ((tres["n_gaussians"], jres["n_gaussians"]),
                     (tm.slam.n_active, jm.slam.n_active)):
        assert abs(got - ref) <= N_RTOL * ref, (got, ref)
    # every mapping event prunes (pruning_dict.start_after 0) and compacts
    assert len(tpruned) >= 2
    if key == "FR_frontier":
        # grown from 512 slots at least twice (capacity_growth 2)
        assert tcap[-1] >= 512 * 4
        assert len(set(tcap)) >= 2


def test_recon_and_eval_match(episodes):
    _k, (jres, _ja, jm, _jc, _jp), (tres, _ta, tm, _tc, _tp) = episodes
    docs = []
    for m in (jm, tm):
        with open(os.path.join(m.eval_dir, "metrics_curve.yaml")) as f:
            docs.append(yaml.safe_load(f))
    ref, got = docs
    assert [s["step"] for s in got["steps"]] == \
        [s["step"] for s in ref["steps"]]
    for rs, gs in zip(ref["steps"], got["steps"]):
        assert gs.keys() == rs.keys()
        for k in rs:
            np.testing.assert_allclose(gs[k], rs[k], rtol=1e-6,
                                       err_msg=f"step {rs['step']} {k}")
    for k in jres["recon"]:
        np.testing.assert_allclose(tres["recon"][k], jres["recon"][k],
                                   rtol=1e-6, err_msg=k)
    ref, got = jres["eval"], tres["eval"]
    assert got["n_poses"] == ref["n_poses"] == EVAL_POSES
    assert got["n_seen"] == ref["n_seen"]
    for k, tol in (("psnr", 0.05), ("psnr_seen", 0.05), ("ssim", 1e-3),
                   ("ssim_seen", 1e-3), ("lpips_proxy", 1e-3)):
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])
    for k in ("depth_mae", "depth_mae_seen"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-2, err_msg=k)
