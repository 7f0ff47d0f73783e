"""The reference against the port at a tiny size on the CPU: the scene's
raycast and the evaluation's poses to the bit, LPIPS and the Fisher
diagonal to rounding, and the live-pair count against a direct count."""
import numpy as np
import pytest
import torch

from reference import fisher as ref_fisher
from reference import gaussians as ref
from reference import image_metrics, poses, scene


@pytest.fixture(scope="module")
def world():
    from fisher_nerf_customized_tpu_torch.envs.fake_sim import (BoxScene,
                                                                FakeSim)
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    sc = BoxScene.multi_room(seed=11)
    cam = Camera(fx=24.0, fy=24.0, cx=24.0, cy=24.0, width=48, height=48)
    return sc, cam, FakeSim(sc, cam, device="cpu")


def test_eval_poses_and_raycast_equal(world):
    from fisher_nerf_customized_tpu_torch.engine.eval import (
        uniform_eval_poses)
    sc, cam, sim = world
    got = poses.eval_poses(sc, 6, 1.25, 99)
    np.testing.assert_array_equal(got, uniform_eval_poses(sc, 6, 1.25, 99))
    rgb, depth = sim.render_at_batch(got)
    b = [torch.as_tensor(x) for x in sc.boxes()]
    rgb2, depth2 = scene.raycast(*b, torch.as_tensor(got), cam.fx, cam.fy,
                                 cam.cx, cam.cy, cam.width, cam.height)
    assert torch.equal(rgb, rgb2) and torch.equal(depth, depth2)


def test_lpips_matches_the_port():
    from entries.eval import lpips_weights
    from fisher_nerf_customized_tpu_torch.models.perceptual import LPIPSAlex
    w = lpips_weights(5, "cpu")
    net = LPIPSAlex()
    net.load_state_dict(w)
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(2, 1, 64, 64, 3, generator=g)
    want = float(net(a, b)[0])
    got = float(image_metrics.lpips_alex(a[0], b[0], w))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)


def _map(n=600, seed=3):
    g = torch.Generator().manual_seed(seed)
    return dict(
        means3D=torch.rand(n, 3, generator=g) * torch.tensor([2.0, 2.0, 2.0])
        + torch.tensor([-1.0, -1.0, 1.5]),
        log_scales=torch.log(torch.rand(n, 3, generator=g) * 0.05 + 0.01),
        unnorm_rotations=torch.randn(n, 4, generator=g),
        logit_opacities=torch.randn(n, 1, generator=g),
        rgb_colors=torch.rand(n, 3, generator=g))


def test_fisher_matches_the_port():
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    from fisher_nerf_customized_tpu_torch.ops.fisher import fisher_diag_batch
    from fisher_nerf_customized_tpu_torch.ops.rasterize import RenderSettings
    p = _map()
    cam = Camera(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)
    w2cs = torch.eye(4).repeat(3, 1, 1)
    w2cs[1, 0, 3], w2cs[2, 1, 3] = 0.2, -0.1
    for full in (False, True):
        want = fisher_diag_batch(
            cam, w2cs, p["means3D"], torch.exp(p["log_scales"]),
            p["unnorm_rotations"], torch.sigmoid(p["logit_opacities"][:, 0]),
            p["rgb_colors"], grad_value=1e-3, settings=RenderSettings(
                tile_size=16, max_per_tile=64, chunk=32),
            full_chain=full)["H"]
        got = ref_fisher.fisher_diag(p, len(p["means3D"]), w2cs,
                                     ref.Camera(32.0, 32.0, 32.0, 32.0, 64,
                                                64), 16, 64, 32, 1e-3, full)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_live_pairs_match_a_direct_count():
    """Per pixel, every Gaussian front to back (no tiles): alpha >= 1/255
    met while T >= 1e-4."""
    p = _map(200, 4)
    cam = ref.Camera(16.0, 16.0, 16.0, 16.0, 32, 32)
    w2c = torch.eye(4)
    (pairs, vis), = ref.live_pairs(p, 200, w2c[None], cam)
    mc = p["means3D"]
    pr = ref.project(mc, torch.exp(p["log_scales"]), p["unnorm_rotations"],
                     cam)
    order = torch.argsort(pr.depth)
    opac = torch.sigmoid(p["logit_opacities"][:, 0])
    rows = torch.cat([pr.mean2d, pr.conic, opac[:, None]], -1)[order]
    ok = pr.valid[order]
    n = 0
    for y in range(32):
        for x in range(32):
            a = ref.pair_alpha(rows[ok][None], torch.tensor([[[x + 0.0]]]),
                               torch.tensor([[[y + 0.0]]]))[0, :, 0]
            t = torch.cumprod(torch.cat([torch.ones(1), 1 - a]), 0)[:-1]
            n += int(((a > 0) & (t >= 1e-4)).sum())
    assert vis == int(pr.valid.sum()) and pairs == n
