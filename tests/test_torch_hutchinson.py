"""The Hutchinson estimators and the P-optimality scores (ops/fisher.py),
JAX package against the PyTorch port on the CPU, and the probe-batched
K2 twin against the single one.

The JAX package draws its probes inside hutchinson_diag and block_jtj
with jax.random.normal(key, (K, H, W, C)); torch cannot reproduce that
stream, so the port is fed the same draws (ROADMAP.md, hazard f).  The
JAX package runs its Pallas forward and backward blends (interpret
mode), whose conventions K1 and K2 follow.

Tolerances, each with its reason:
  * estimates from the same probes: rtol 1e-4 with an atol of 1e-6 of
    the largest entry (the VJP's f32 sums over pixels and slots run in
    another order);
  * diag-based T-opt and D-opt: rtol 1e-6 (a sum of the same f32 terms);
    block-based ones on well-conditioned blocks: rtol 1e-5 (the two
    packages' f32 eigensolvers round differently);
  * many probes against the exact diag(JᵀJ): rtol 0.25, as the JAX
    package's own test (512 probes; Hutchinson's relative error falls as
    sqrt(2 / K));
  * the probe-batched twin against a loop of the single twin: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops import fisher as jf
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu.ops.rasterize import RenderSettings as JRS
from fisher_nerf_customized_tpu_torch.ops import cuda_blend_bwd
from fisher_nerf_customized_tpu_torch.ops import fisher as tf
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera
from fisher_nerf_customized_tpu_torch.ops.rasterize import (
    RenderSettings as TRS, render)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JSET = JRS(tile_size=8, max_per_tile=16, chunk=8, diff_backend="pallas",
           fwd_backend="pallas")
TSET = TRS(tile_size=8, max_per_tile=16, chunk=8)


def scene(n=40, seed=0, n_active=35):
    rng = np.random.default_rng(seed)
    return dict(
        means=np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                        rng.uniform(1.0, 2.5, n)], -1).astype(np.float32),
        scales=rng.uniform(0.05, 0.15, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opac=rng.uniform(0.4, 0.9, n).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        active=np.arange(n) < n_active)


def cams(size):
    kw = dict(fx=float(size), fy=float(size), cx=size / 2, cy=size / 2,
              width=size, height=size)
    return JCamera(**kw), TCamera(**kw)


def run_both(fn_name, n_probes, size=24, seed=3):
    s = scene()
    jc, tc = cams(size)
    key = jax.random.PRNGKey(seed)
    ref = getattr(jf, fn_name)(
        jc, *(jnp.asarray(s[k]) for k in ("means", "scales", "quats", "opac",
                                          "colors")),
        key, n_probes=n_probes, active=jnp.asarray(s["active"]),
        settings=JSET)
    # the JAX package's own draw inside its estimator
    zs = np.array(jax.random.normal(key, (n_probes, size, size, 3),
                                    jnp.float32))
    got = getattr(tf, fn_name)(
        tc, *(torch.from_numpy(s[k].copy()) for k in ("means", "scales",
                                                      "quats", "opac",
                                                      "colors")),
        torch.from_numpy(zs), active=torch.from_numpy(s["active"]),
        settings=TSET)
    return ref, got


def assert_close(got, ref):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())


def test_hutchinson_diag_matches_jax_with_its_draws():
    ref, got = run_both("hutchinson_diag", 4)
    for k in ("means", "scales", "rotations", "opacity"):
        assert got[k].shape == ref[k].shape
        assert_close(got[k], ref[k])
    np.testing.assert_array_equal(got["visible"].numpy(),
                                  np.asarray(ref["visible"]))


def test_block_jtj_matches_jax_with_its_draws():
    ref, got = run_both("block_jtj", 2)
    assert got["blocks"].shape == ref["blocks"].shape == (40, 11, 11)
    assert_close(got["blocks"], ref["blocks"])
    np.testing.assert_array_equal(got["visible"].numpy(),
                                  np.asarray(ref["visible"]))


def test_popt_scores_match_jax():
    rng = np.random.default_rng(0)
    h = rng.uniform(0.0, 2.0, (300, 11)).astype(np.float32)
    j = rng.uniform(0.0, 1.0, (300, 11)).astype(np.float32)
    j[:30] = 0.0
    for fn in ("topt_score_from_diags", "dopt_score_from_diags"):
        ref = float(getattr(jf, fn)(jnp.asarray(h), jnp.asarray(j)))
        got = float(getattr(tf, fn)(torch.from_numpy(h), torch.from_numpy(j)))
        np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=fn)
    # well-conditioned PSD blocks
    a = rng.normal(size=(60, 11, 11)).astype(np.float32)
    hb = (a @ a.transpose(0, 2, 1) / 11 + np.eye(11, dtype=np.float32))
    b = rng.normal(size=(60, 11, 11)).astype(np.float32)
    jb = (b @ b.transpose(0, 2, 1) / 11).astype(np.float32)
    valid = rng.uniform(size=60) < 0.8
    for fn in ("topt_score_blocks", "dopt_score_blocks"):
        ref = float(getattr(jf, fn)(jnp.asarray(hb), jnp.asarray(jb),
                                    jnp.asarray(valid)))
        got = float(getattr(tf, fn)(torch.from_numpy(hb), torch.from_numpy(jb),
                                    torch.from_numpy(valid)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=fn)


def test_hutchinson_matches_exact_diag_small():
    """Many probes converge to the exact diag(JᵀJ) of the opacities, here
    from the Jacobian of the port's own render (its backward is K2's
    twin) on the JAX test's 16x16 scene."""
    cam = TCamera(fx=16.0, fy=16.0, cx=8.0, cy=8.0, width=16, height=16)
    st = TRS(tile_size=8, max_per_tile=16, chunk=8)
    rng = np.random.default_rng(0)
    n = 6
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    means = t(np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                        rng.uniform(1.0, 2.5, n)], -1))
    scales = t(rng.uniform(0.08, 0.15, (n, 3)))
    quats = t(rng.normal(size=(n, 4)))
    opac = t(rng.uniform(0.4, 0.8, n))
    colors = t(rng.uniform(0, 1, (n, 3)))
    gen = torch.Generator().manual_seed(0)
    zs = torch.randn((512, 16, 16, 3), generator=gen)
    got = tf.hutchinson_diag(cam, means, scales, quats, opac, colors, zs,
                             settings=st)["opacity"][:, 0]

    def f(op):
        return render(cam, means, scales, quats, op, colors,
                      settings=st)["color"].reshape(-1)
    jac = torch.autograd.functional.jacobian(f, opac)        # (P*3, N)
    exact = (jac ** 2).sum(dim=0)
    assert float(exact.min()) > 0
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0.25,
                               atol=1e-7)


@pytest.mark.parametrize("n_probes", [1, 3, 8])
def test_probe_batched_twin_equals_a_loop_of_the_single_twin(n_probes):
    rng = np.random.default_rng(n_probes)
    n_tiles, k, p, c = 5, 32, 64, 3
    packed = np.zeros((n_tiles, k, 8 + c), np.float32)
    packed[..., 0:2] = rng.uniform(-2, 10, (n_tiles, k, 2))
    packed[..., 2] = rng.uniform(0.05, 0.5, (n_tiles, k))
    packed[..., 3] = rng.uniform(-0.05, 0.05, (n_tiles, k))
    packed[..., 4] = rng.uniform(0.05, 0.5, (n_tiles, k))
    packed[..., 5] = rng.uniform(0.1, 0.99, (n_tiles, k))
    packed[..., 6] = rng.uniform(1, 3, (n_tiles, k))
    packed[..., 7] = 1.0
    packed[..., 8:] = rng.uniform(0, 1, (n_tiles, k, c))
    pix = np.stack(np.meshgrid(np.arange(8.0), np.arange(8.0))[::1], 0)
    pix_xy = np.tile(pix.reshape(1, 2, p), (n_tiles, 1, 1)).astype(np.float32)
    nvalid = np.array([32, 20, 0, 7, 31], np.int32)
    gcol = rng.normal(size=(n_probes, n_tiles, p, c)).astype(np.float32)
    g_t = rng.normal(size=(n_probes, n_tiles, p)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (packed, pix_xy)]
    got = cuda_blend_bwd.cuda_blend_bwd_probes(
        *args, torch.from_numpy(gcol), torch.from_numpy(g_t),
        torch.from_numpy(nvalid), 8)
    assert got.shape == (n_probes, n_tiles, k, 6 + c)
    loop = torch.stack([cuda_blend_bwd.cuda_blend_bwd(
        *args, torch.from_numpy(gcol[b]), torch.from_numpy(g_t[b]),
        torch.from_numpy(nvalid), 8) for b in range(n_probes)])
    assert torch.equal(got, loop)
    assert float(got.abs().max()) > 0
