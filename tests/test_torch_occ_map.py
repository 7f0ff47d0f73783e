"""The standalone occupancy map (planning/occ_map.py), the JAX package
against the PyTorch port on the CPU, on tests/test_occ_map.py's cases:
the same FakeSim frames fed to both OccupancyMaps give the same map cell
for cell (occ_update is the JAX package's arithmetic), the same labels,
explored ratio and ego crops; a map saved by one package loads in the
other; est_occ_from_pcd and crop_grid equal the JAX copies.
"""
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.planning import occ_map as jocc
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera
from fisher_nerf_customized_tpu_torch.planning import occ_map as tocc

KW = dict(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)


@pytest.fixture(scope="module")
def maps():
    scene = BoxScene(room_lo=(-2, 0, -2), room_hi=(2, 2.5, 2),
                     obstacles=[((0.5, 0.0, 0.5), (1.0, 1.2, 1.0))])
    sim = FakeSim(scene, Camera(**KW), turn_angle=45.0)
    kw = dict(grid_dim=(128, 96), cell_size=0.1, map_center=(0.1, -0.2))
    jm = jocc.OccupancyMap(Camera(**KW), **kw)
    tm = tocc.OccupancyMap(TCamera(**KW), device="cpu", **kw)
    obs = sim.reset()
    ratios = []
    for a in [None] + [2] * 7 + [1, 1]:
        if a is not None:
            obs = sim.step(a)
        jm.update(obs["depth"], obs["c2w"])
        got = tm.update(np.asarray(obs["depth"]), obs["c2w"])
        assert isinstance(got, torch.Tensor) and got.shape == (3, 96, 128)
        ratios.append((tm.explored_ratio(), jm.explored_ratio()))
    return jm, tm, obs, ratios


def test_updates_match_cell_for_cell(maps):
    jm, tm, _obs, ratios = maps
    np.testing.assert_array_equal(tm.occ_map.numpy(), np.asarray(jm.occ_map))
    np.testing.assert_array_equal(tm.labels(), jm.labels())
    assert [r[0] for r in ratios] == [r[1] for r in ratios]
    assert ratios[0][0] > 0 and ratios[-1][0] > ratios[0][0]


def test_ego_crop_and_save_load_across_packages(maps, tmp_path):
    jm, tm, obs, _ratios = maps
    for crop in (32, 200):
        got = tm.ego_crop(obs["c2w"], crop=crop)
        assert got.shape == (3, crop, crop)
        np.testing.assert_array_equal(got, jm.ego_crop(obs["c2w"],
                                                       crop=crop))
    tm.save(str(tmp_path / "t.npz"))
    jm.save(str(tmp_path / "j.npz"))
    t2 = tocc.OccupancyMap(TCamera(**KW), grid_dim=(8, 8), device="cpu")
    t2.load(str(tmp_path / "j.npz"))
    j2 = jocc.OccupancyMap(Camera(**KW), grid_dim=(8, 8))
    j2.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(t2.labels(), j2.labels())
    assert t2.explored_ratio() == jm.explored_ratio()
    assert t2.cell_size == j2.cell_size == 0.1
    np.testing.assert_array_equal(t2.map_center, np.asarray(j2.map_center))


def test_est_occ_from_pcd_and_crop_grid_match():
    rng = np.random.default_rng(0)
    pts = rng.uniform([-3, -0.5, -3], [3, 2.5, 3], (500, 3))
    pts[0] = [0.0, 5.0, 1.0]                        # above the band
    for center in ((0.0, 0.0), (0.5, -1.0)):
        got = tocc.est_occ_from_pcd(pts, (40, 32), 0.1, center)
        np.testing.assert_array_equal(
            got, jocc.est_occ_from_pcd(pts, (40, 32), 0.1, center))
        assert got[1].sum() < len(pts)
    assert tocc.est_occ_from_pcd(pts[:1], (8, 8), 0.1, (0, 0))[1].sum() == 0
    g = rng.uniform(size=(3, 16, 20)).astype(np.float32)
    for cell, crop in (((0, 0), 8), ((15, 19), 9), ((7, 3), 40)):
        got = tocc.crop_grid(g, cell, crop)
        np.testing.assert_array_equal(got, jocc.crop_grid(g, cell, crop))
    assert tocc.crop_grid(g, (0, 0), 8)[0, 0, 0] == 0.0
