"""The legacy in-SLAM planning API (GaussianSLAM.get_top_down_map,
uncertainty_scores, global_planning with DBSCAN targeting,
DFS_acq_score_planning), utils/clustering.py::dbscan and the planner's
occ_coord_to_3d and get_map: the JAX package against the PyTorch port on
the CPU.

The map is tests/test_torch_slice.py's (64x64, 5 frames of
multi_room(3): init, densify, 3 keyframes; here a Gaussian every 2
pixels and a full-size Fisher camera), built by the JAX package and
loaded into the port from its checkpoint, so both hold the same
Gaussians.  Tolerances: dbscan's labels, the top-down map, the planner's
map and cells equal exactly; uncertainty_scores from each package's own
H_train to rtol 1e-2 (test_torch_slice.py's H_train tolerance: the JAX
package's XLA engine never stops a tile early).  global_planning's rounds
take the JAX package's H_train in both packages (recorded round by
round), since its choices (the 0.8 quantile, the DBSCAN cluster) compare
uncertainties with strict inequalities: then the candidate poses, the
round counter and n_active after the culling must be equal and the view
scores agree to rtol 1e-2.  The DFS takes each package's own Hessians
and must choose the same actions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu.models import slam as jslam
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.planning.planner import (
    AstarPlanner as JPlanner)
from fisher_nerf_customized_tpu.utils.clustering import dbscan as jdbscan
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.models import slam as tslam
from fisher_nerf_customized_tpu_torch.planning.planner import (
    AstarPlanner as TPlanner)
from fisher_nerf_customized_tpu_torch.utils.clustering import dbscan

from test_torch_slice import ACTIONS, IMG, build_map, make_cfg

RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def legacy_cfg(get_defaults, workdir):
    """The slice's settings with Gaussians every 2 pixels and a full-size
    Fisher camera: the keyframes then see most Gaussians in the camera's
    height band, so that fewer than a fifth share the top uncertainty
    (H_train 0) and the 0.8 quantile leaves points to cluster."""
    cfg = make_cfg(get_defaults, workdir)
    cfg.downsample_pcd = 2
    cfg.tpu.fisher_downsample = 1
    cfg.explore.sample_view_num = 16
    cfg.explore.prune_invisible = True
    return cfg


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("legacy")
    cam = Camera(fx=IMG / 2, fy=IMG / 2, cx=IMG / 2, cy=IMG / 2, width=IMG,
                 height=IMG)
    scene = BoxScene.multi_room(seed=3)
    sim = FakeSim(scene, cam, forward_step=0.25, turn_angle=30.0)
    obs = [sim.reset(yaw=0.3)] + [sim.step(a) for a in ACTIONS]
    frames = [(np.array(o["rgb"]), np.array(o["depth"]),
               np.linalg.inv(o["c2w"]).astype(np.float32)) for o in obs]
    js = jslam.GaussianSLAM(legacy_cfg(jcfg, tmp / "jax"),
                            eval_dir=str(tmp / "jax_eval"))
    build_map(jslam, js, frames, jnp.asarray)
    path = js.save(len(frames) - 1)
    ts = tslam.GaussianSLAM(legacy_cfg(tcfg, tmp / "torch"),
                            eval_dir=str(tmp / "torch_eval"), device="cpu")
    ts.load(path)
    assert ts.n_active == js.n_active and ts.frame_idx == js.frame_idx
    planners = []
    for cls, cfg, kw in ((JPlanner, js.cfg, {}),
                         (TPlanner, ts.cfg, dict(device="cpu"))):
        p = cls(cfg, seed=0, **kw)
        p.init(np.linalg.inv(frames[0][2]), np.asarray(cam.intrinsics),
               img_size=(IMG, IMG))
        for t, (_c, depth, w2c) in enumerate(frames):
            p.update_occ_map(depth, np.linalg.inv(w2c), t)
        planners.append(p)
    return dict(js=js, ts=ts, frames=frames, scene=scene,
                planners=planners)


def test_dbscan_labels_equal_the_jax_copy():
    rng = np.random.default_rng(0)
    blobs = [rng.normal(c, 0.03, (60, 3)) for c in
             ([0, 0, 0], [0.5, 0, 0], [0.62, 0, 0], [2, 1, 0])]
    chain = np.stack([np.linspace(-1, -0.2, 40), np.zeros(40),
                      np.zeros(40)], -1)
    noise = rng.uniform(-3, 3, (40, 3))
    pts = rng.permutation(np.concatenate(blobs + [chain, noise]))
    for eps, ms in ((0.1, 5), (0.05, 3), (0.2, 8)):
        got = dbscan(pts, eps=eps, min_samples=ms)
        np.testing.assert_array_equal(got, jdbscan(pts, eps=eps,
                                                   min_samples=ms))
        assert got.max() >= 1 and (got == -1).any()
    assert len(dbscan(np.zeros((0, 3)))) == 0


def test_top_down_map_and_uncertainty_match(built):
    js, ts = built["js"], built["ts"]
    for kw in ({}, dict(cell_size=0.2, grid_dim=64)):
        np.testing.assert_array_equal(ts.get_top_down_map(**kw),
                                      js.get_top_down_map(**kw))
    assert ts.cam_height == js.cam_height
    ref, got = js.uncertainty_scores(), ts.uncertainty_scores()
    assert got.shape == ref.shape == (ts.state.capacity,)
    assert (got[:ts.n_active] > 0).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_array_equal(ts.get_gaussian_xyz().numpy(),
                                  np.asarray(js.get_gaussian_xyz()))
    assert ts.gs_pts_cnt({"means": None}) == js.gs_pts_cnt() == ts.n_active


def test_planner_map_and_cells_match(built):
    jp, tp = built["planners"]
    got = tp.get_map()
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.get_map()))
    cells = np.stack(np.nonzero(got.argmax(0).numpy() == 2), -1)[::7]
    assert len(cells) > 10
    np.testing.assert_array_equal(tp.occ_coord_to_3d(cells),
                                  jp.occ_coord_to_3d(cells))


def test_global_planning_rounds_match(built, tmp_path):
    """A frontier round, a DBSCAN round with the low-H culling, and a round
    in which no candidate is navigable, in both packages on copies of the
    same map and the same random stream."""
    ts0, js = built["ts"], built["js"]
    scene = built["scene"]
    jp, _tp = built["planners"]
    frontier, _free = jp.build_frontiers(js.gaussian_points)
    assert frontier is not None and len(frontier) > 0
    path = js.save(1000)
    (tmp_path / "jax").mkdir()      # the JAX package's export needs it
    js = jslam.GaussianSLAM(js.cfg, eval_dir=str(tmp_path / "jax"))
    js.load(path)
    ts = tslam.GaussianSLAM(ts0.cfg, eval_dir=str(tmp_path / "torch"),
                            device="cpu")
    ts.load(path)
    ts.rng.bit_generator.state = js.rng.bit_generator.state
    h_trains = []
    j_h = js.compute_H_train
    js.compute_H_train = lambda *a: (h_trains.append(np.asarray(j_h())),
                                     h_trains[-1])[1]
    calls = iter(range(3))
    ts.compute_H_train = lambda *a: torch.from_numpy(
        h_trains[next(calls)])

    def navigable(p):
        return scene.is_navigable((p[0], 0.0, p[2]))

    def find_path(p):
        if p[0] > 3.0:
            raise RuntimeError("no path")

    rounds = [dict(is_navigable=navigable, frontier=frontier),
              dict(is_navigable=navigable, find_path=find_path),
              dict(is_navigable=lambda p: False)]
    n_before = js.n_active
    for i, kw in enumerate(rounds):
        ref = js.global_planning(**kw)
        got = ts.global_planning(**kw)
        assert ts.selection == js.selection == i + 1
        assert ts.n_active == js.n_active
        if i == 2:
            assert ref == (None, None) and got == (None, None)
            continue
        (rs, rc), (gs, gc) = ref, got
        assert isinstance(gs, torch.Tensor) and isinstance(gc, torch.Tensor)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
        assert len(gs) == len(rs) >= 1 and np.isfinite(gs.numpy()).all()
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=RTOL)
    assert js.n_active < n_before           # the DBSCAN round culled
    assert ts.rng.bit_generator.state == js.rng.bit_generator.state
    name = f"global_planning_iter{js.frame_idx}.npz"
    with np.load(tmp_path / "jax" / name) as ref, \
            np.load(tmp_path / "torch" / name) as got:
        for k in ("segmentated_labels", "max_label", "points_index_range"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_dfs_lookahead_takes_the_same_actions(built):
    js, ts, scene = built["js"], built["ts"], built["scene"]
    c2ws = [np.linalg.inv(f[2]) for f in built["frames"]]

    def navigable(p):
        return scene.is_navigable((p[0], 0.0, p[2]))

    kw = dict(max_depth=2, forward_step=0.25, turn_angle=30.0)
    for start in (c2ws[-1], c2ws[0]):
        ref = js.DFS_acq_score_planning([start], navigable, **kw)
        got = ts.DFS_acq_score_planning([start], navigable, **kw)
        assert got == ref and len(got) == 2
    for noop in ("pause", "resume", "stop", "color_refinement"):
        assert getattr(ts, noop)() is None
