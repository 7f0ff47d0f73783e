"""ReplaySim and eval_nvs over a replayed trajectory, JAX package against
the PyTorch port on the CPU.

The trajectory is tests/test_slam.py's (48x48 FakeSim frames, 8 actions
after the first frame).  Both packages map it with ground-truth poses
(`init` on frame 0, then `track_rgbd`; one mapping event of 12 Adam
steps, the JAX package on its Pallas blends in interpret mode, whose
conventions K1 and K2 follow), then run eval_nvs over a ReplaySim of the
recorded frames.  The port's eval_nvs protocol is tests/test_slam.py's
test_eval_nvs_protocol, mirrored.

Tolerances, each with its reason:
  * ReplaySim's observations: equal (the same float32 frames);
  * per-frame PSNR within 1e-3 dB, SSIM and depth_l1 rtol 1e-4, the
    valid flags equal: the two maps part in the last bits (Adam's first
    steps on gradients at the f32 noise floor, tests/test_torch_mapping.py)
    and JAX's XLA forward never stops a tile early, where K1's twin stops
    at T < 1e-4.
"""
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine import eval as jeval
from fisher_nerf_customized_tpu.envs.fake_sim import ReplaySim as JReplay
from fisher_nerf_customized_tpu.models import slam as jslam
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine import eval as teval
from fisher_nerf_customized_tpu_torch.envs import ReplaySim
from fisher_nerf_customized_tpu_torch.models import GaussianSLAM

from test_slam import make_sim, small_cfg

ACTIONS = [2, 1, 1, 2, 1, 3, 1, 1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def record():
    """The trajectory's frames as float32 numpy arrays: (colors, depths,
    c2ws)."""
    sim = make_sim()
    obs = [sim.reset(start_xz=(0.0, 0.0), yaw=0.2)]
    obs += [sim.step(a) for a in ACTIONS]
    return ([np.array(o["rgb"], np.float32) for o in obs],
            [np.array(o["depth"], np.float32) for o in obs],
            [np.array(o["c2w"], np.float32) for o in obs])


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replay")
    colors, depths, c2ws = record()
    jcfg = small_cfg(tmp / "jax")
    jcfg.tpu.blend_backward = "pallas"
    js = jslam.GaussianSLAM(jcfg)
    cfg = tcfg()
    cfg.merge_from_other(small_cfg(tmp / "torch").to_dict())
    ts = GaussianSLAM(cfg, device="cpu")
    for slam in (js, ts):
        slam.init(colors[0], depths[0], np.linalg.inv(c2ws[0]))
        for c, d, p in zip(colors[1:], depths[1:], c2ws[1:]):
            slam.track_rgbd(c, d, gt_w2c=np.linalg.inv(p))
    return dict(js=js, ts=ts, frames=(colors, depths, c2ws), tmp=tmp)


def test_replay_sim_matches_jax():
    colors, depths, c2ws = record()
    ref = JReplay(colors, depths, c2ws)
    got = ReplaySim(colors, depths, c2ws, device="cpu")
    assert len(got) == len(ref) == len(ACTIONS) + 1
    assert got.colors.dtype == got.depths.dtype == torch.float32
    assert got.colors.shape == (len(ref),) + colors[0].shape
    assert got.c2ws.dtype == np.float32

    def same(o, r):
        assert set(o) == set(r) == {"rgb", "depth", "c2w"}
        assert isinstance(o["rgb"], torch.Tensor)
        assert isinstance(o["c2w"], np.ndarray)
        np.testing.assert_array_equal(o["rgb"].numpy(), r["rgb"])
        np.testing.assert_array_equal(o["depth"].numpy(), r["depth"])
        np.testing.assert_array_equal(o["c2w"], r["c2w"])

    same(got.reset(), ref.reset())
    for a in ACTIONS[:3]:
        same(got.step(a), ref.step(a))
    same(got.get_observations(), ref.get_observations())
    for _ in range(len(ACTIONS) + 3):          # past the end: clamps
        same(got.step(), ref.step())
    assert got.t == ref.t == len(ACTIONS) + 6
    # the pose is a copy
    obs = got.get_observations()
    obs["c2w"][0, 3] += 1.0
    assert got.get_observations()["c2w"][0, 3] == c2ws[-1][0, 3]
    # frames given as tensors are kept as they are, as float32
    again = ReplaySim([torch.from_numpy(c).double() for c in colors],
                      [torch.from_numpy(d) for d in depths], c2ws,
                      device="cpu")
    assert torch.equal(again.colors, got.colors)
    assert torch.equal(again.depths, got.depths)


def test_eval_nvs_protocol(mapped):
    """tests/test_slam.py::test_eval_nvs_protocol on the port."""
    ts, tmp = mapped["ts"], mapped["tmp"]
    colors, depths, c2ws = mapped["frames"]
    replay = ReplaySim(colors, depths, c2ws, device="cpu")
    res = teval.eval_nvs(ts, replay, eval_every=1,
                         out_dir=str(tmp / "nvs"))
    assert res["n_eval_frames"] == len(colors) - 1      # frame 0 skipped
    assert res["n_valid_frames"] >= 1
    assert np.isfinite(res["psnr"]) and res["psnr"] > 10.0
    assert 0.0 <= res["ssim"] <= 1.0
    assert res["depth_l1"] < 0.5
    assert (tmp / "nvs" / "psnr.txt").exists()
    assert (tmp / "nvs" / "valid_nvs_frames.npy").exists()

    res3 = teval.eval_nvs(ts, replay, eval_every=3)
    kept = [f["frame"] for f in res3["per_frame"]]
    assert kept == [i for i in range(len(colors) - 1)
                    if i == 0 or (i + 1) % 3 == 0]

    far_c2w = np.eye(4, dtype=np.float32)
    far_c2w[:3, 3] = (50.0, 1.2, 50.0)
    res_far = teval.eval_nvs(ts, [(colors[0], depths[0], c2ws[0]),
                                  (colors[1], depths[1], far_c2w)])
    assert res_far["n_eval_frames"] == 1
    assert res_far["n_valid_frames"] == 0
    assert np.isnan(res_far["psnr"])


@pytest.mark.parametrize("eval_every", [1, 3])
def test_eval_nvs_matches_jax(mapped, eval_every):
    js, ts = mapped["js"], mapped["ts"]
    assert ts.n_active == js.n_active
    colors, depths, c2ws = mapped["frames"]
    ref = jeval.eval_nvs(js, JReplay(colors, depths, c2ws),
                         eval_every=eval_every)
    got = teval.eval_nvs(ts, ReplaySim(colors, depths, c2ws, device="cpu"),
                         eval_every=eval_every)
    assert got["n_eval_frames"] == ref["n_eval_frames"]
    assert got["valid_nvs_frames"] == ref["valid_nvs_frames"]
    assert got["n_valid_frames"] == ref["n_valid_frames"]
    if eval_every == 1:
        assert ref["n_valid_frames"] >= 1
    for g, r in zip(got["per_frame"], ref["per_frame"]):
        assert g["frame"] == r["frame"]
        assert abs(g["psnr"] - r["psnr"]) < 1e-3, (g, r)
        np.testing.assert_allclose(g["ssim"], r["ssim"], rtol=1e-4)
        np.testing.assert_allclose(g["depth_l1"], r["depth_l1"], rtol=1e-4)
    for k in ("psnr", "ssim", "depth_l1"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4)
