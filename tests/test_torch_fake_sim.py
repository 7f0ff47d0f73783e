"""The port's FakeSim against the JAX package's: same scenes, same action
script, same frames.  rgb and depth agree to atol 1e-4 except at box-edge
argmin ties, where at most 0.1 % of the pixels may pick the other box."""
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.envs import fake_sim as jsim
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.envs import fake_sim as tsim
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

CAMKW = dict(fx=48.0, fy=48.0, cx=48.0, cy=48.0, width=96, height=96)
ACTIONS = [2, 2, 1, 1, 3, 1, 1, 1, 2, 1, 1, 3, 3, 1]


def frac_off(a, b, atol=1e-4):
    diff = np.abs(np.asarray(a) - np.asarray(b))
    if diff.ndim == 3:
        diff = diff.max(-1)
    return float((diff > atol).mean())


@pytest.mark.parametrize("kind", ["default", "multi_room"])
def test_fake_sim_frames_match_jax(kind):
    make = getattr(jsim.BoxScene, kind)
    jscene = make(seed=4)
    tscene = getattr(tsim.BoxScene, kind)(seed=4)
    assert tscene.obstacles == jscene.obstacles
    jenv = jsim.FakeSim(jscene, JCamera(**CAMKW), forward_step=0.25,
                        turn_angle=30.0)
    tenv = tsim.FakeSim(tscene, TCamera(**CAMKW), forward_step=0.25,
                        turn_angle=30.0, device="cpu")
    jo, to = jenv.reset(yaw=0.4), tenv.reset(yaw=0.4)
    for a in [None] + ACTIONS:
        if a is not None:
            jo, to = jenv.step(a), tenv.step(a)
        np.testing.assert_allclose(to["c2w"], jo["c2w"], atol=1e-6)
        assert isinstance(to["rgb"], torch.Tensor)
        assert to["rgb"].shape == (96, 96, 3) and to["depth"].shape == (96, 96)
        assert frac_off(to["depth"], jo["depth"]) <= 1e-3
        assert frac_off(to["rgb"], jo["rgb"]) <= 1e-3
    assert tenv.collided_last == jenv.collided_last


def test_fake_sim_render_at_and_navigable():
    scene = tsim.BoxScene.multi_room(seed=1)
    jscene = jsim.BoxScene.multi_room(seed=1)
    env = tsim.FakeSim(scene, TCamera(**CAMKW), device="cpu")
    jenv = jsim.FakeSim(jscene, JCamera(**CAMKW))
    c2w = env.c2w.copy()
    c2w[:3, 3] += [0.5, 0.0, -0.3]
    rgb, depth = env.render_at(c2w)
    jrgb, jdepth = jenv.render_at(c2w)
    assert frac_off(depth, jdepth) <= 1e-3 and frac_off(rgb, jrgb) <= 1e-3
    rng = np.random.default_rng(0)
    pts = rng.uniform(-6, 6, (200, 3))
    assert [env.is_navigable(p) for p in pts] == \
        [jenv.is_navigable(p) for p in pts]


def test_box_scene_ground_truth_methods():
    """sample_navigable, sample_surface_points, surface_area and
    surface_distance: the JAX package's numbers from the same draws."""
    for kind in ("default", "multi_room"):
        t = getattr(tsim.BoxScene, kind)(seed=6)
        j = getattr(jsim.BoxScene, kind)(seed=6)
        np.testing.assert_array_equal(
            t.sample_navigable(np.random.default_rng(1), 50),
            j.sample_navigable(np.random.default_rng(1), 50))
        np.testing.assert_array_equal(t.sample_surface_points(3000),
                                      j.sample_surface_points(3000))
        np.testing.assert_array_equal(
            t.sample_surface_points(500, rng=np.random.default_rng(4)),
            j.sample_surface_points(500, rng=np.random.default_rng(4)))
        assert t.surface_area() == j.surface_area()
        pts = np.random.default_rng(2).uniform(-7, 7, (400, 3))
        np.testing.assert_array_equal(t.surface_distance(pts),
                                      j.surface_distance(pts))


def test_render_at_batch():
    """One batched raycast equals render_at at each pose to the bit, and
    the JAX package's render_at_batch as render_at does."""
    from fisher_nerf_customized_tpu_torch.engine.eval import (
        uniform_eval_poses)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = tsim.BoxScene.multi_room(seed=3)
        env = tsim.FakeSim(scene, TCamera(**CAMKW), device="cpu")
        jenv = jsim.FakeSim(jsim.BoxScene.multi_room(seed=3),
                            JCamera(**CAMKW))
        poses = uniform_eval_poses(scene, 6, 1.25)
        rgb, depth = env.render_at_batch(poses)
        jrgb, jdepth = jenv.render_at_batch(poses)
        assert rgb.shape == (6, 96, 96, 3) and depth.shape == (6, 96, 96)
        for i, c2w in enumerate(poses):
            one_rgb, one_depth = env.render_at(c2w)
            assert torch.equal(rgb[i], one_rgb)
            assert torch.equal(depth[i], one_depth)
            assert frac_off(depth[i], jdepth[i]) <= 1e-3
            assert frac_off(rgb[i], jrgb[i]) <= 1e-3
    finally:
        torch.set_num_threads(n)
