"""SH colours (ops/sh.py), render_sh (ops/rasterize.py) and the naive
reference rasterizer (ops/naive.py), the JAX package against the PyTorch
port on the CPU; and the DROID-SLAM wrapper's gate.

Tolerances: sh_to_rgb to atol 1e-6 and its gradient (the clamp's
masking included) to atol 1e-6; render_sh's image to atol 3e-4 and its
gradients (to the SH coefficients and to the means) to rtol 1e-3 plus
1e-5 of the largest, against the JAX render_sh with its Pallas forward
and backward in interpret mode (test_torch_ops.py's and
test_torch_blend_bwd.py's render tolerances); render_naive to atol 1e-5
against the JAX one, and to atol 3e-4 against the port's tiled render on
a scene whose tiles never overflow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.models import droid_wrapper as jdroid
from fisher_nerf_customized_tpu.ops import naive as jnaive
from fisher_nerf_customized_tpu.ops import rasterize as jras
from fisher_nerf_customized_tpu.ops import sh as jsh
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.models import droid_wrapper as tdroid
from fisher_nerf_customized_tpu_torch.ops import naive as tnaive
from fisher_nerf_customized_tpu_torch.ops import rasterize as tras
from fisher_nerf_customized_tpu_torch.ops import sh as tsh
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

CAM = dict(fx=32.0, fy=32.0, cx=16.0, cy=16.0, width=32, height=32)


def scene(n=60, seed=3, opac=(0.3, 0.9)):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(2.0, 5.0, n)], -1)
    scales = rng.uniform(0.05, 0.2, (n, 3))
    quats = rng.normal(size=(n, 4))
    opacities = rng.uniform(*opac, n)
    sh = rng.normal(scale=0.3, size=(n, 16, 3))
    return [np.asarray(x, np.float32)
            for x in (means, scales, quats, opacities, sh)]


def pose(yaw=0.3, t=(0.2, -0.1, 0.4)):
    w2c = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    w2c[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    w2c[:3, 3] = t
    return w2c


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_to_rgb_and_its_gradient_match_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(scale=1.5, size=(64, 16, 3)).astype(np.float32)
    means = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    campos = np.array([0.3, -0.2, -1.0], np.float32)
    ref = np.asarray(jsh.sh_to_rgb(jnp.asarray(sh), jnp.asarray(means),
                                   jnp.asarray(campos), deg=deg))
    t_sh = torch.from_numpy(sh).requires_grad_()
    t_means = torch.from_numpy(means).requires_grad_()
    got = tsh.sh_to_rgb(t_sh, t_means, torch.from_numpy(campos), deg=deg)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-6)
    assert (ref == 0).any() and got.min() >= 0        # some channels clamp
    w = rng.normal(size=ref.shape).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    g_sh, g_means = jax.grad(
        lambda s, m: jnp.sum(jsh.sh_to_rgb(s, m, jnp.asarray(campos),
                                           deg=deg) * w),
        argnums=(0, 1))(jnp.asarray(sh), jnp.asarray(means))
    np.testing.assert_allclose(t_sh.grad.numpy(), np.asarray(g_sh),
                               atol=1e-6)
    # degree 0 does not depend on the view: no gradient reaches the means
    g = t_means.grad if deg else torch.zeros_like(t_means)
    assert (t_means.grad is None) == (deg == 0)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_means), atol=1e-6)
    # a clamped channel passes no gradient to any coefficient
    clamped = ref == 0
    assert (t_sh.grad.numpy()[:, 0][clamped] == 0).all()
    assert tsh.num_sh_coeffs(deg) == jsh.num_sh_coeffs(deg)
    with pytest.raises(ValueError):
        tsh.sh_to_rgb(t_sh[:, :tsh.num_sh_coeffs(deg) - 1], t_means,
                      torch.from_numpy(campos), deg=deg) if deg else \
            tsh.sh_to_rgb(t_sh, t_means, torch.from_numpy(campos), deg=4)


def test_render_sh_and_its_gradients_match_jax():
    means, scales, quats, opac, sh = scene()
    w2c = pose()
    st_j = jras.RenderSettings(tile_size=8, max_per_tile=64, chunk=16,
                               diff_backend="pallas", fwd_backend="pallas")
    st_t = tras.RenderSettings(tile_size=8, max_per_tile=64, chunk=16)
    target = np.random.default_rng(9).uniform(
        0, 1, (32, 32, 3)).astype(np.float32)

    def jloss(m, s):
        out = jras.render_sh(JCamera(**CAM), m, jnp.asarray(w2c),
                             jnp.asarray(scales), jnp.asarray(quats),
                             jnp.asarray(opac), s, deg=3, settings=st_j)
        return jnp.mean(jnp.abs(out["color"] - target)), out["color"]

    (_l, ref_img), (g_means, g_sh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(means),
                                             jnp.asarray(sh))
    t_means = torch.from_numpy(means).requires_grad_()
    t_sh = torch.from_numpy(sh).requires_grad_()
    out = tras.render_sh(TCamera(**CAM), t_means, torch.from_numpy(w2c),
                         torch.from_numpy(scales), torch.from_numpy(quats),
                         torch.from_numpy(opac), t_sh, deg=3, settings=st_t)
    assert out["color"].shape == (32, 32, 3)
    np.testing.assert_allclose(out["color"].detach().numpy(),
                               np.asarray(ref_img), atol=3e-4)
    torch.mean(torch.abs(out["color"] - torch.from_numpy(target))).backward()
    for got, ref in ((t_sh.grad, g_sh), (t_means.grad, g_means)):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                                   atol=1e-5 * scale)
    vis = out["radii"].detach().numpy() > 0
    assert (np.abs(t_sh.grad.numpy()[vis, 0]).sum(-1) > 0).any()


def test_render_sh_degree_0_is_render_with_the_dc_colour():
    means, scales, quats, opac, sh = (torch.from_numpy(x) for x in scene())
    w2c = torch.from_numpy(pose())
    st = tras.RenderSettings(tile_size=8, max_per_tile=64, chunk=16)
    got = tras.render_sh(TCamera(**CAM), means, w2c, scales, quats, opac,
                         sh[:, :1], deg=0, settings=st)
    colors = torch.relu(tsh.SH_C0 * sh[:, 0] + 0.5)
    ref = tras.render(TCamera(**CAM), means @ w2c[:3, :3].T + w2c[:3, 3],
                      scales, quats, opac, colors, settings=st)
    for k in ("color", "depth", "final_t", "radii"):
        assert torch.equal(got[k], ref[k]), k


def test_render_naive_matches_jax_and_the_tiled_render():
    means, scales, quats, opac, sh = scene(n=80, seed=5)
    colors = np.random.default_rng(2).uniform(0, 1, (80, 4)).astype(
        np.float32)
    w2c = pose(yaw=-0.2)
    means_cam = (means @ w2c[:3, :3].T + w2c[:3, 3]).astype(np.float32)
    active = np.arange(80) % 9 != 0
    bg = np.asarray([0.2, 0.1, 0.3, 0.0], np.float32)
    ref = jnaive.render_naive(JCamera(**CAM), *(jnp.asarray(x) for x in (
        means_cam, scales, quats, opac, colors)), bg=jnp.asarray(bg),
        active=jnp.asarray(active), tile_size=8)
    t_args = [torch.from_numpy(x) for x in (means_cam, scales, quats, opac,
                                            colors)]
    got = tnaive.render_naive(TCamera(**CAM), *t_args,
                              bg=torch.from_numpy(bg),
                              active=torch.from_numpy(active), tile_size=8)
    for k in ("color", "depth", "final_t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(ref["radii"]))
    tiled = tras.render(TCamera(**CAM), *t_args, bg=torch.from_numpy(bg),
                        active=torch.from_numpy(active),
                        settings=tras.RenderSettings(tile_size=8,
                                                     max_per_tile=128,
                                                     chunk=32))
    assert int(tiled["overflow"]) == 0
    for k in ("color", "final_t"):
        np.testing.assert_allclose(got[k].numpy(), tiled[k].numpy(),
                                   atol=3e-4, err_msg=k)
    assert float((got["depth"] - tiled["depth"]).abs().gt(1e-2).float()
                 .mean()) <= 1e-2


def test_droid_wrapper_is_gated_as_in_jax():
    assert tdroid.DROID_AVAILABLE == jdroid.DROID_AVAILABLE is False
    with pytest.raises(ImportError) as got:
        tdroid.DroidWrapper()
    with pytest.raises(ImportError) as ref:
        jdroid.DroidWrapper()
    assert str(got.value) == str(ref.value)
    assert "tracking.with_droid: false" in str(got.value)
