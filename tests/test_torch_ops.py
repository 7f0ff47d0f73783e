"""Parity of the PyTorch port's projection, binning and render with the
JAX package on identical numpy inputs (CPU; the port's plain twins)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops import binning as jbin
from fisher_nerf_customized_tpu.ops import projection as jproj
from fisher_nerf_customized_tpu.ops import rasterize as jras
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.ops import binning as tbin
from fisher_nerf_customized_tpu_torch.ops import projection as tproj
from fisher_nerf_customized_tpu_torch.ops import rasterize as tras
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera


def cams(w, h, f):
    kw = dict(fx=float(f), fy=float(f), cx=w / 2, cy=h / 2, width=w, height=h)
    return JCamera(**kw), TCamera(**kw)


def make_scene(n, seed, spread=1.2, zr=(1.0, 6.0)):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-spread, spread, n),
                      rng.uniform(-spread, spread, n),
                      rng.uniform(*zr, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.15, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    active = np.arange(n) < n - n // 10          # last 10 % inactive
    return means, scales, quats, opac, colors, active


def j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def test_preprocess_matches_jax():
    jc, tc = cams(64, 48, 40)
    means, scales, quats, _o, _c, active = make_scene(400, 0, spread=2.5,
                                                      zr=(-0.5, 6.0))
    ref = jproj.preprocess(*j(means, scales, quats), jc,
                           active=jnp.asarray(active))
    got = tproj.preprocess(*t(means, scales, quats), tc,
                           active=torch.from_numpy(active))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(ref.radius))
    ok = np.asarray(ref.valid)
    for name in ("mean2d", "conic", "cov2d", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy()[ok],
                                   np.asarray(getattr(ref, name))[ok],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_conic_mean_jac_matches_jax_autodiff():
    """The port writes d(conic)/d(mean_cam) out analytically; the JAX
    package takes it by jacfwd.  Includes fov-clamped Gaussians."""
    jc, tc = cams(64, 64, 32)
    means, scales, quats, _o, _c, _a = make_scene(300, 1, spread=4.0,
                                                  zr=(0.5, 5.0))
    prep = jproj.preprocess(*j(means, scales, quats), jc)
    ref = jproj.conic_mean_jac(jnp.asarray(means),
                               jproj.build_cov3d(*j(scales, quats)), jc,
                               valid=prep.valid)
    got = tproj.conic_mean_jac(torch.from_numpy(means),
                               tproj.build_cov3d(*t(scales, quats)), tc,
                               valid=torch.from_numpy(np.array(prep.valid)))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("size,tile,k,n", [
    (64, 16, 32, 300),      # single-level top-k path
    (128, 16, 64, 600),     # hierarchical path
    (128, 16, 8, 600),      # hierarchical with coarse overflow (Kc = 64)
])
def test_tile_bin_matches_jax(size, tile, k, n):
    jc, tc = cams(size, size, size * 0.6)
    means, scales, quats, _o, _c, active = make_scene(n, 2)
    prep = jproj.preprocess(*j(means, scales, quats), jc,
                            active=jnp.asarray(active))
    ref = jbin.tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                        size, size, tile, k)
    got = tbin.tile_bin(*t(prep.mean2d, prep.radius, prep.depth, prep.valid),
                        size, size, tile, k)
    sv = np.asarray(ref.slot_valid)
    np.testing.assert_array_equal(got.slot_valid.numpy(), sv)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert int(got.overflow) == int(ref.overflow)
    # invalid slots point at an arbitrary Gaussian in both packages
    np.testing.assert_array_equal(got.table.numpy()[sv],
                                  np.asarray(ref.table)[sv])
    if k == 8:
        assert int(ref.overflow) > int(np.maximum(
            np.asarray(ref.counts) - k, 0).sum()), "no coarse overflow"


@pytest.mark.parametrize("bg", [None, (1.0, 1.0, 1.0, 0.0)])
def test_render_matches_jax(bg):
    """The port blends with the K1 plain twin, which stops a tile at
    T < 1e-4 like the Pallas kernel; the JAX XLA blend does not stop, so
    the tolerances are those of the Pallas-vs-XLA blend test."""
    jc, tc = cams(64, 64, 64)
    means, scales, quats, opac, colors, active = make_scene(500, 3)
    st_j = jras.RenderSettings(tile_size=16, max_per_tile=128, chunk=32)
    st_t = tras.RenderSettings(tile_size=16, max_per_tile=128, chunk=32)
    ref = jras.render(jc, *j(means, scales, quats, opac, colors),
                      bg=None if bg is None else jnp.asarray(bg),
                      active=jnp.asarray(active), settings=st_j)
    got = tras.render(tc, *t(means, scales, quats, opac, colors),
                      bg=None if bg is None else torch.tensor(bg),
                      active=torch.from_numpy(active), settings=st_t)
    np.testing.assert_allclose(got["color"].numpy(), np.asarray(ref["color"]),
                               atol=3e-4)
    np.testing.assert_allclose(got["final_t"].numpy(),
                               np.asarray(ref["final_t"]), atol=3e-4)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]),
                               atol=1e-2)
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(ref["radii"]))
    assert int(got["overflow"]) == int(ref["overflow"])


@pytest.mark.parametrize("scale", [1.0, 200.0])
def test_image_metrics_match_jax(scale):
    """SSIM / PSNR / L1 in strict f32; the 200x scale exercises the
    variance-cancellation guards (|E[x²] - mu²| error ~ eps·mu²)."""
    from fisher_nerf_customized_tpu.ops import image as jimg
    from fisher_nerf_customized_tpu_torch.ops import image as timg
    rng = np.random.default_rng(4)
    a = (rng.uniform(0, 1, (40, 48, 3)) * scale).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05 * scale, a.shape), 0,
                None).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(timg.calc_ssim(ta, tb)),
                               float(jimg.calc_ssim(ja, jb)), atol=1e-5)
    np.testing.assert_allclose(float(timg.calc_psnr(ta, tb)),
                               float(jimg.calc_psnr(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(float(timg.l1_loss(ta, tb)),
                               float(jimg.l1_loss(ja, jb)), rtol=1e-5)


def test_ssim_gradient_matches_jax_on_constant_patches():
    """calc_ssim's gradient w.r.t. img1 against jax.grad, on inputs with
    constant patches (one of them 0), where the variance floor
    max(E[x²] - mu², 0) sits at or next to its tie.  There the variance's
    own derivative vanishes, so this checks the whole SSIM gradient, not
    the tie's split (test_project_cov2d_gradient_at_ties_matches_jax
    does).  Tolerance rtol 1e-4 plus 1e-5 of the largest entry: the two
    filters sum in different orders, and E[x²] - mu² cancels."""
    from fisher_nerf_customized_tpu.ops import image as jimg
    from fisher_nerf_customized_tpu_torch.ops import image as timg
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    a[4:20, 6:24] = 0.0
    a[18:30, 20:38] = 0.5
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    b[6:16, 8:18] = 0.25
    ref = np.asarray(jax.grad(jimg.calc_ssim)(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_()
    timg.calc_ssim(ta, torch.from_numpy(b)).backward()
    np.testing.assert_allclose(ta.grad.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_project_cov2d_gradient_at_ties_matches_jax():
    """project_cov2d's gradient w.r.t. the camera-frame means where the
    fov clip and the z floor tie exactly (x/z = 1.3 tan_fov, z = 1e-6):
    jnp.clip and jnp.maximum split a tie's gradient 0.5/0.5, and so must
    the port.  Tolerance rtol 1e-5 (f32 rounding of the same formulas)."""
    jc, tc = cams(64, 64, 32)                 # tan_fov 1, fov clip 1.3
    means = np.array([[1.3, 0.2, 1.0], [-0.4, -1.3, 1.0], [0.1, 0.2, 1e-6],
                      [0.3, -0.5, 2.0]], np.float32)
    cov = np.array([[0.02, 0.001, 0.002, 0.03, 0.001, 0.04]] * 4, np.float32)
    w = np.array([1.0, 0.7, 0.3], np.float32)

    def jloss(m):
        (a, b, c), (tx, ty, z) = jproj.project_cov2d(m, jnp.asarray(cov), jc)
        return jnp.sum(w[0] * a + w[1] * b + w[2] * c) + jnp.sum(tx + ty + z)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(means)))
    tm = torch.from_numpy(means).requires_grad_()
    (a, b, c), (tx, ty, z) = tproj.project_cov2d(tm, torch.from_numpy(cov), tc)
    (torch.sum(w[0] * a + w[1] * b + w[2] * c)
     + torch.sum(tx + ty + z)).backward()
    np.testing.assert_allclose(tm.grad.numpy(), ref, rtol=1e-5, atol=1e-6)
