"""The port's utils/pointcloud.py against the JAX package's numpy path
(frames handed over as numpy arrays), on FakeSim frames: the subsampled
cloud equal to the bit over 10 frames, with a window flush in the middle;
write_ply byte-equal, read_ply round-tripping it."""
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.utils import pointcloud as jpcl
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene, FakeSim
from fisher_nerf_customized_tpu_torch.ops.camera import Camera
from fisher_nerf_customized_tpu_torch.utils import pointcloud as tpcl

ACTIONS = [2, 1, 1, 3, 1, 2, 2, 1, 1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    cam = Camera(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)
    sim = FakeSim(BoxScene.multi_room(seed=2), cam, forward_step=0.25,
                  turn_angle=30.0, device="cpu")
    obs = [sim.reset()] + [sim.step(a) for a in ACTIONS]
    # a frame with far and missing depth (masked by 0 < z < max_depth)
    far = dict(obs[-1])
    far["depth"] = obs[-1]["depth"].clone()
    far["depth"][:8] = 0.0
    far["depth"][8:16] = 20.0
    return obs[:-1] + [far], sim.intrinsics


def test_backproject_depth(frames):
    obs, intr = frames
    for o in obs[:3]:
        d, c = o["depth"].numpy(), o["rgb"].numpy()
        ref_p, ref_c = jpcl.backproject_depth(d, intr, o["c2w"], 10.0, c)
        got_p, got_c = tpcl.backproject_depth(d, intr, o["c2w"], 10.0, c)
        assert got_p.dtype == ref_p.dtype == np.float64
        np.testing.assert_array_equal(got_p, ref_p)
        np.testing.assert_array_equal(got_c, ref_c)


@pytest.mark.parametrize("window", [4, 64])
def test_global_point_cloud(frames, window):
    """10 frames; window 4 flushes twice in the middle, 64 only at get.
    get_new's chunks follow too."""
    obs, intr = frames
    ref = jpcl.GlobalPointCloud(keep_ratio=0.05, seed=5)
    got = tpcl.GlobalPointCloud(keep_ratio=0.05, seed=5, window=window)
    cursor_r = cursor_g = 0
    for i, o in enumerate(obs):
        ref.add_frame(o["depth"].numpy(), intr, o["c2w"],
                      color=o["rgb"].numpy())
        got.add_frame(o["depth"], intr, o["c2w"], color=o["rgb"])
        if i in (2, 7):
            new_r, cursor_r = ref.get_new(cursor_r)
            new_g, cursor_g = got.get_new(cursor_g)
            assert cursor_g == cursor_r
            np.testing.assert_array_equal(new_g, new_r)
    np.testing.assert_array_equal(got.get(), ref.get())
    assert got.n_points() == len(ref.get()) > 0
    np.testing.assert_array_equal(np.concatenate(got.colors),
                                  np.concatenate(ref.colors))
    assert got.rng.bit_generator.state == ref.rng.bit_generator.state


def test_ply_and_save_round_trip(frames, tmp_path):
    obs, intr = frames
    clouds = []
    for mod in (jpcl, tpcl):
        pc = mod.GlobalPointCloud(keep_ratio=0.2, seed=1)
        for o in obs[:4]:
            pc.add_frame(o["depth"].numpy(), intr, o["c2w"],
                         color=o["rgb"].numpy())
        clouds.append(pc)
    for colored in (True, False):
        paths = []
        for name, mod, pc in (("j", jpcl, clouds[0]), ("t", tpcl, clouds[1])):
            path = tmp_path / f"{name}{colored}.ply"
            if colored:
                pc.save_ply(str(path))
            else:
                mod.write_ply(str(path), pc.get())
            paths.append(path)
        assert paths[0].read_bytes() == paths[1].read_bytes()
        np.testing.assert_array_equal(tpcl.read_ply(str(paths[1])),
                                      clouds[0].get())
    path = tmp_path / "pcl.npz"
    clouds[1].save(str(path), ckpt_t=7)
    back = tpcl.GlobalPointCloud()
    back.load(str(path))
    np.testing.assert_array_equal(back.get(), clouds[1].get())
    np.testing.assert_array_equal(np.concatenate(back.colors),
                                  np.concatenate(clouds[1].colors))
    assert int(np.load(path)["ckpt_t"]) == 7
    # a cloud the JAX package saved loads too
    clouds[0].save(str(tmp_path / "jax.npz"))
    back.load(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(back.get(), clouds[0].get())
