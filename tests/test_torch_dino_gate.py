"""The DINO gate of object mapping, the port against the JAX package: the
histogram extractor's descriptors and the bank's metrics and decisions
(the port's numpy copy: equal), and a 16-step object episode with the
gate in both packages (tests/test_torch_object_episode.py's setting:
48x48, the SimObject at (0, 1.8), object mapping every 2 steps, the JAX
package's Hutchinson draws): the same accept/veto sequence, the same
actions, and the same object n_active.
"""
import os

import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine import dino_gate as jdg
from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs import fake_sim as jsim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch import cli
from fisher_nerf_customized_tpu_torch.engine import dino_gate as tdg
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs import fake_sim as tsim
from fisher_nerf_customized_tpu_torch.models import object_slam as tos
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG, episode_cfg
from test_torch_episode import port_cfg
from test_torch_object_episode import jax_probe_draw

STEPS = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(seed, n=6, size=56):
    """Seeded RGB images with blob masks; every other one a near copy of
    the one before (the gate should veto those)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2 and out:
            rgb = np.clip(out[-1][0] + rng.normal(0, 0.01, out[-1][0].shape),
                          0, 1).astype(np.float32)
            out.append((rgb, out[-1][1]))
            continue
        rgb = rng.random((size, size, 3)).astype(np.float32)
        rgb[:, :size // 2] *= rng.random(3).astype(np.float32)
        yy, xx = np.mgrid[0:size, 0:size]
        cy, cx = rng.integers(10, size - 10, 2)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.integers(80, 400)
        out.append((rgb, mask))
    return out


@pytest.mark.parametrize("patch,bins", [(14, 8), (8, 6)])
def test_extractor_descriptors_equal(patch, bins):
    ref = jdg.PatchDescriptorExtractor(patch_size=patch, bins=bins)
    got = tdg.PatchDescriptorExtractor(patch_size=patch, bins=bins)
    for rgb, mask in images(patch) + [(np.zeros((40, 40, 3), np.float32),
                                       np.zeros((40, 40), bool))]:
        d = got(rgb, mask)
        np.testing.assert_array_equal(d, ref(rgb, mask))
        assert d.dtype == np.float32 and d.shape[1] == 4 * bins


def test_bank_decisions_equal():
    ext = tdg.PatchDescriptorExtractor()
    ref, got = jdg.DinoBank(max_size=3), tdg.DinoBank(max_size=3)
    decisions = []
    for i, (rgb, mask) in enumerate(images(5, n=12)):
        d = ext(rgb, mask)
        assert got.similarity_metrics(d) == ref.similarity_metrics(d)
        assert got.is_distinct(d) == ref.is_distinct(d)
        a, b = got.add_if_distinct(d, force=i == 0), \
            ref.add_if_distinct(d, force=i == 0)
        assert a == b
        decisions.append(a)
        assert len(got) == len(ref) <= 3
    assert True in decisions and False in decisions
    for mask in (np.zeros((20, 30), bool), images(1, n=1)[0][1]):
        assert tdg.object_center_error(mask) == \
            jdg.object_center_error(mask)


def run(pkg, tmp_path, mp):
    cfg = episode_cfg(tmp_path / pkg, steps=STEPS)
    cfg.map_obj_every = 2
    cfg.keyframe_obj_every = 2
    cfg.explore_object.sample_view_num = 8
    decisions = []
    if pkg == "jax":
        mod, cam_t, drv, dg, kw = jsim, JCamera, jdriver, jdg, {}
        sim_kw = dict(device_obs=False)
    else:
        cfg = port_cfg(cfg)
        mod, cam_t, drv, dg = tsim, TCamera, tdriver, tdg
        kw = sim_kw = dict(device="cpu")
        mp.setattr(tos.GaussianObjectSLAM, "probe_draw", jax_probe_draw)
    add = dg.DinoBank.add_if_distinct

    def recording(self, descs, force=False):
        out = add(self, descs, force=force)
        decisions.append((bool(force), bool(out), len(descs)))
        return out

    mp.setattr(dg.DinoBank, "add_if_distinct", recording)
    cam = cam_t(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                width=IMG, height=IMG)
    scene = mod.BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                         obstacles=[])
    obj = mod.SimObject(scene, semantic_id=100, size=(0.5, 1.2, 0.5),
                        start_xz=(0.0, 1.8), speed=0.03, seed=0)
    sim = mod.FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0,
                      dynamic_object=obj, seed=0, **sim_kw)
    actions = []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0,
                              eval_dir=os.path.join(cfg.workdir,
                                                    cfg.run_name),
                              object_scene=True, dino_gate=True, **kw)
    result = mapper.test_navigation(n_eval_poses=0)
    return dict(actions=actions, decisions=decisions, mapper=mapper,
                result=result)


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dino")
    with pytest.MonkeyPatch.context() as mp:
        ref = run("jax", tmp, mp)
    with pytest.MonkeyPatch.context() as mp:
        got = run("torch", tmp, mp)
    return ref, got


def test_dino_gated_episodes_decide_alike(episodes):
    ref, got = episodes
    tm, jm = got["mapper"], ref["mapper"]
    assert tm.dino_bank is not None and jm.dino_bank is not None
    assert got["result"]["steps"] == ref["result"]["steps"] == STEPS
    # the init frame is forced in, then each object frame is decided
    assert got["decisions"][0][:2] == (True, True)
    assert len(got["decisions"]) == len(tm.dino_log) >= 4
    assert [d[1] for d in got["decisions"]] == [a for _t, a in tm.dino_log]
    assert any(not a for _t, a in tm.dino_log), "no frame was vetoed"
    assert len(tm.dino_bank) >= 1
    assert got["decisions"] == ref["decisions"]
    assert got["actions"] == ref["actions"]
    assert tm.obj_slam.n_active == jm.obj_slam.n_active > 0
    assert got["result"]["timing"]["dino_gate"]["count"] == len(tm.dino_log)


def test_dino_gate_needs_the_object_branch(tmp_path):
    """Without --object_scene the gate is not made (as in the JAX
    package); --dino_gate parses and is handed to the driver."""
    args = cli.build_parser().parse_args(["--dino_gate", "--device", "cpu"])
    assert args.dino_gate
    cfg = port_cfg(episode_cfg(tmp_path))
    cam = TCamera(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                  width=IMG, height=IMG)
    sim = tsim.FakeSim(tsim.BoxScene(), cam, device="cpu")
    assert tdriver.ActiveMapper(cfg, sim, device="cpu",
                                dino_gate=True).dino_bank is None
    gated = tdriver.ActiveMapper(cfg, sim, device="cpu", dino_gate=True,
                                 object_scene=True)
    assert isinstance(gated.dino_bank, tdg.DinoBank)


def test_vit_gate_decides_as_jax(tmp_path):
    """--dino_weights on the object branch: the driver's gate hands the
    frame to the ViT as the tensor the sim returned (no host copy) and
    decides as the JAX package's ViT extractor and bank do on the same
    frames: the decisions equal, with a veto among them."""
    from fisher_nerf_customized_tpu.models import perceptual as jp
    from test_perceptual import _tiny_vit_params
    p = _tiny_vit_params(np.random.default_rng(7))
    ckpt = tmp_path / "vit.pth"
    torch.save({k: torch.tensor(v) for k, v in p.items()}, ckpt)
    cfg = port_cfg(episode_cfg(tmp_path))
    cam = TCamera(fx=float(IMG), fy=float(IMG), cx=IMG / 2, cy=IMG / 2,
                  width=IMG, height=IMG)
    sim = tsim.FakeSim(tsim.BoxScene(), cam, device="cpu")
    mapper = tdriver.ActiveMapper(cfg, sim, device="cpu", object_scene=True,
                                  dino_weights=str(ckpt))
    seen = []
    extract = mapper._dino_extractor.__call__

    def recording(rgb, mask):
        seen.append(rgb)
        return extract(rgb, mask)

    mapper._dino_extractor = recording
    ref_x, ref_bank = jp.ViTPatchExtractor(p, 1), jdg.DinoBank()
    want = []
    for t, (rgb, mask) in enumerate(images(3, n=8)):
        frame = torch.from_numpy(rgb)
        mapper._dino_decide({"rgb": frame}, mask, t, force=t == 0)
        assert seen[-1] is frame
        want.append((t, ref_bank.add_if_distinct(ref_x(rgb, mask),
                                                 force=t == 0)))
    assert mapper.dino_log == want
    assert any(not a for _t, a in want), "no frame was vetoed"
    assert len(mapper.dino_bank) == len(ref_bank) >= 1
