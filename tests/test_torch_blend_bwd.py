"""K2, the blend backward, on the CPU: the port's plain twin against the
JAX package's Pallas kernel in interpret mode on identical rows, and the
gradients of the port's differentiable render (K1 forward, K2 backward)
against the JAX render with the Pallas forward and backward.

Tolerances: twin against Pallas rtol 1e-3 plus atol 1e-5 of the
largest value of each output column (the Pallas kernel forms the
in-chunk transmittance by exp of a log-space matmul and the suffix sums
by a triangular matmul, the twin by cumprod and cumsum: the two round
differently); render gradients rtol 1e-3 plus atol 1e-5 of each
group's largest gradient (the same, plus the preprocess chain run by two
autodiff systems).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops import rasterize as jras
from fisher_nerf_customized_tpu.ops.binning import tile_bin
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.ops.pallas_blend import pack_tile_params
from fisher_nerf_customized_tpu.ops.pallas_blend_bwd import (
    pallas_blend_bwd_slots)
from fisher_nerf_customized_tpu.ops.projection import preprocess
from fisher_nerf_customized_tpu.ops.rasterize import tile_pixel_coords
from fisher_nerf_customized_tpu_torch.ops import cuda_blend, cuda_blend_bwd
from fisher_nerf_customized_tpu_torch.ops import rasterize as tras
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

CAM = Camera(fx=64.0, fy=64.0, cx=32.0, cy=32.0, width=64, height=64)
TILE, K, CHUNK = 16, 128, 64          # two chunks per tile


def scene(kind, seed, n_ch, opac_max=0.95):
    rng = np.random.default_rng(seed)
    if kind == "random":
        n = 400
        means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                          rng.uniform(1.0, 6.0, n)], -1)
        scales = rng.uniform(0.03, 0.15, (n, 3))
        opac = rng.uniform(0.2, opac_max, n)
    elif kind == "opaque_wall":            # saturates: early termination
        n = 400
        means = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                          rng.uniform(1.0, 1.2, n)], -1)
        scales = np.full((n, 3), 0.15)
        opac = np.full(n, 0.98)
    else:                                  # "corner": most tiles empty
        n = 80
        means = np.stack([rng.uniform(0.8, 1.2, n), rng.uniform(0.8, 1.2, n),
                          rng.uniform(1.5, 3.0, n)], -1)
        scales = rng.uniform(0.02, 0.06, (n, 3))
        opac = rng.uniform(0.3, opac_max, n)
    quats = rng.normal(size=(n, 4))
    colors = rng.uniform(0, 1, (n, n_ch))
    means, scales, quats, opac, colors = (
        jnp.asarray(np.asarray(x, np.float32))
        for x in (means, scales, quats, opac, colors))
    prep = preprocess(means, scales, quats, CAM)
    bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                    CAM.width, CAM.height, TILE, K)
    packed = np.array(pack_tile_params(prep, bins, opac, colors))
    pix_x, pix_y = tile_pixel_coords(bins.n_tiles_x, bins.n_tiles_y, TILE)
    pix_xy = np.array(jnp.stack([pix_x, pix_y], axis=1))
    nvalid = np.asarray(bins.slot_valid).sum(-1).astype(np.int32)
    n_tiles, p = pix_xy.shape[0], pix_xy.shape[-1]
    gcol = rng.normal(size=(n_tiles, p, n_ch)).astype(np.float32)
    g_t = rng.normal(size=(n_tiles, p)).astype(np.float32)
    return packed, pix_xy, nvalid, gcol, g_t


def assert_close_per_column(got, ref, rtol, atol_frac):
    scale = np.abs(ref).reshape(-1, ref.shape[-1]).max(axis=0)
    assert scale.max() > 0
    err = np.abs(got - ref)
    bad = err > rtol * np.abs(ref) + atol_frac * scale + 1e-30
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} off; max err per column "
        f"{err.reshape(-1, ref.shape[-1]).max(axis=0)} of {scale}")


@pytest.mark.parametrize("kind", ["random", "opaque_wall", "corner"])
@pytest.mark.parametrize("n_ch", [3, 4])
def test_blend_bwd_plain_matches_pallas_interpret(kind, n_ch):
    packed, pix_xy, nvalid, gcol, g_t = scene(
        kind, {"random": 0, "opaque_wall": 2, "corner": 5}[kind], n_ch)
    if kind == "random":           # tiles with nvalid < K and two chunks
        assert ((nvalid < K) & (nvalid > CHUNK)).any()
    if kind == "corner":
        assert (nvalid == 0).sum() >= len(nvalid) // 2
    # the Pallas kernel's layout: no valid column, validity folded into
    # the opacity
    packed_j = np.concatenate([packed[..., :7], packed[..., 8:]], axis=-1)
    packed_j[..., 5] *= packed[..., 7]
    ref = np.asarray(pallas_blend_bwd_slots(
        jnp.asarray(packed_j), jnp.asarray(pix_xy), jnp.asarray(gcol),
        jnp.asarray(g_t)[:, None, :], jnp.asarray(nvalid), CHUNK,
        interpret=True))
    got = cuda_blend_bwd.cuda_blend_bwd(
        *(torch.from_numpy(x) for x in (packed, pix_xy, gcol, g_t, nvalid)),
        CHUNK).numpy()
    assert got.shape == ref.shape == (len(nvalid), K, 6 + n_ch)
    assert_close_per_column(got, ref, 1e-3, 1e-5)
    # past nvalid: exactly zero
    past = np.arange(K)[None, :] >= nvalid[:, None]
    assert (got[past] == 0).all()


def test_blend_bwd_zero_past_the_stop():
    """The opaque wall saturates its tiles in the first chunk: the second
    chunk's valid rows lie past the forward's stop and get 0."""
    packed, pix_xy, nvalid, gcol, g_t = scene("opaque_wall", 2, 4)
    args = [torch.from_numpy(x) for x in (packed, pix_xy, nvalid)]
    _out, walked = cuda_blend._blend_walk(*args, CHUNK, 15.0)
    stopped = (walked.numpy() < nvalid)
    assert stopped.any()
    got = cuda_blend_bwd.blend_bwd_plain(
        *(torch.from_numpy(x) for x in (packed, pix_xy, gcol, g_t, nvalid)),
        CHUNK).numpy()
    for i in np.nonzero(stopped)[0]:
        assert (got[i, walked[i]:] == 0).all()
        assert np.abs(got[i, :walked[i]]).max() > 0


@pytest.mark.parametrize("kind", ["random", "corner"])
def test_blend_function_matches_autograd_of_the_plain_forward(kind):
    """Away from the 0.99 alpha clamp (opacity <= 0.9), where the custom
    VJP's conventions agree with plain autodiff, BlendFunction's gradient
    w.r.t. the packed rows equals torch autograd through K1's plain twin."""
    packed, pix_xy, nvalid, gcol, g_t = scene(
        kind, {"random": 0, "corner": 5}[kind], 4, opac_max=0.9)
    pk = torch.from_numpy(packed)
    pix, nv = torch.from_numpy(pix_xy), torch.from_numpy(nvalid)
    gc, gt = torch.from_numpy(gcol), torch.from_numpy(g_t)

    def grad_of(fn):
        x = pk.clone().requires_grad_()
        color, t_final, _med = fn(x)
        (torch.sum(color * gc) + torch.sum(t_final * gt)).backward()
        return x.grad.numpy()

    got = grad_of(lambda x: tras.BlendFunction.apply(x, pix, nv, CHUNK, 15.0))
    ref = grad_of(lambda x: cuda_blend.blend_plain(x, pix, nv, CHUNK, 15.0))
    valid = packed[..., 7] > 0.5
    ref[..., 6:8] = 0.0                     # depth and valid: no gradient
    ref[~valid] = 0.0
    assert_close_per_column(got, ref, 1e-3, 1e-5)


def test_blend_bwd_wrapper_rejects_unsupported_device():
    packed, pix_xy, nvalid, gcol, g_t = scene("random", 0, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_blend_bwd.cuda_blend_bwd(
            *(torch.from_numpy(x).to("meta")
              for x in (packed, pix_xy, gcol, g_t, nvalid)), CHUNK)


@pytest.fixture(scope="module")
def grad_scene():
    """The scene of tests/test_rasterize.py's Pallas-backward test."""
    rng = np.random.default_rng(3)
    n = 800
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 2, n),
                      rng.uniform(0.5, 6, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.85, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    bg = np.asarray([0.3, 0.2, 0.1], np.float32)
    kw = dict(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)

    st = jras.RenderSettings(tile_size=8, max_per_tile=64, chunk=16,
                             diff_backend="pallas", fwd_backend="pallas")

    def jloss(mc, sc, qt, op, co):
        out = jras.render(Camera(**kw), mc, sc, qt, op, co,
                          bg=jnp.asarray(bg), settings=st)
        return jnp.mean(jnp.abs(out["color"] - jnp.asarray(target)))

    args = (means, scales, quats, opac, colors)
    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))

    tst = tras.RenderSettings(tile_size=8, max_per_tile=64, chunk=16)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = tras.render(TCamera(**kw), *leaves, bg=torch.from_numpy(bg),
                      settings=tst)
    torch.mean(torch.abs(out["color"] - torch.from_numpy(target))).backward()
    return [np.asarray(r) for r in ref], [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("group", ["means", "scales", "quats", "opacities",
                                   "colors"])
def test_render_gradients_match_jax_pallas_vjp(grad_scene, group):
    i = ["means", "scales", "quats", "opacities", "colors"].index(group)
    ref, got = grad_scene[0][i], grad_scene[1][i]
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5 * scale)
