"""K3 plain twin (the port's Fisher squared backward on the CPU) against
the JAX package's Pallas Fisher kernel in interpret mode, at the 11- and
20-wide packings, and the port's batched fisher_diag_batch against the
JAX one.  Tolerance rtol 5e-3 / atol 1e-8, as in tests/test_fisher.py
(the JAX XLA engine never stops early; the port and Pallas stop a tile
at T < 1e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops import fisher as jfisher
from fisher_nerf_customized_tpu.ops.binning import tile_bin
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu.ops.pallas_fisher import (
    pack_fisher_features, pallas_fisher_slots)
from fisher_nerf_customized_tpu.ops.projection import (build_cov3d,
                                                       conic_mean_jac,
                                                       preprocess)
from fisher_nerf_customized_tpu.ops.rasterize import (
    RenderSettings as JSettings, tile_pixel_coords)
from fisher_nerf_customized_tpu_torch.ops import cuda_fisher
from fisher_nerf_customized_tpu_torch.ops import fisher as tfisher
from fisher_nerf_customized_tpu_torch.ops.binning import tile_bin as ttile_bin
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera
from fisher_nerf_customized_tpu_torch.ops.projection import (
    preprocess as tpreprocess)
from fisher_nerf_customized_tpu_torch.ops.rasterize import (
    RenderSettings as TSettings, tile_pixel_coords as ttile_pixel_coords)

CAMKW = dict(fx=32.0, fy=32.0, cx=32.0, cy=32.0, width=64, height=64)
TILE, K, CHUNK, GV = 16, 64, 16, 2e-3


def scene(seed, n=1200):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 2, n),
                      rng.uniform(0.5, 6, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


@pytest.mark.parametrize("full_chain", [False, True])
def test_fisher_plain_matches_pallas_interpret(full_chain):
    cam = JCamera(**CAMKW)
    means, scales, quats, opac, colors = (jnp.asarray(x) for x in scene(7))
    prep = preprocess(means, scales, quats, cam)
    bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                    cam.width, cam.height, TILE, K)
    cjac = (conic_mean_jac(means, build_cov3d(scales, quats), cam,
                           valid=prep.valid) if full_chain else None)
    packed = np.array(pack_fisher_features(prep, bins, opac, colors, means,
                                           conic_jac=cjac))
    pix_x, pix_y = tile_pixel_coords(bins.n_tiles_x, bins.n_tiles_y, TILE)
    pix_xy = np.array(jnp.stack([pix_x, pix_y], axis=1))
    nvalid = np.asarray(bins.slot_valid).sum(-1).astype(np.int32)
    assert packed.shape[-1] == (20 if full_chain else 11)

    ref = np.asarray(pallas_fisher_slots(
        jnp.asarray(packed), jnp.asarray(pix_xy), jnp.asarray(nvalid), CHUNK,
        GV, cam.fx, cam.fy, interpret=True))
    got = cuda_fisher.cuda_fisher_slots(
        torch.from_numpy(packed)[None], torch.from_numpy(pix_xy),
        torch.from_numpy(nvalid)[None], CHUNK, GV, cam.fx, cam.fy)[0]
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-3, atol=1e-8)


@pytest.mark.parametrize("full_chain", [False, True])
def test_fisher_diag_batch_matches_jax(full_chain):
    means, scales, quats, opac, colors = scene(9, n=600)
    active = np.arange(len(means)) < 550
    w2cs = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    w2cs[1, 0, 3] = 0.4
    c, s = np.cos(0.3), np.sin(0.3)
    w2cs[2, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    w2cs[2, 2, 3] = -0.5
    ref = jfisher.fisher_diag_batch(
        JCamera(**CAMKW), jnp.asarray(w2cs),
        *(jnp.asarray(x) for x in (means, scales, quats, opac, colors)),
        grad_value=GV, active=jnp.asarray(active),
        settings=JSettings(tile_size=TILE, max_per_tile=K, chunk=CHUNK),
        engine="xla", full_chain=full_chain)
    got = tfisher.fisher_diag_batch(
        TCamera(**CAMKW), torch.from_numpy(w2cs),
        *(torch.from_numpy(x) for x in (means, scales, quats, opac, colors)),
        grad_value=GV, active=torch.from_numpy(active),
        settings=TSettings(tile_size=TILE, max_per_tile=K, chunk=CHUNK),
        full_chain=full_chain)
    np.testing.assert_array_equal(got["visible"].numpy(),
                                  np.asarray(ref["visible"]))
    np.testing.assert_allclose(got["H"].numpy(), np.asarray(ref["H"]),
                               rtol=5e-3, atol=1e-8)


def test_fisher_walk_stops_early_on_saturated_tiles():
    """A dense opaque wall saturates: pass 1 must stop some tiles before
    their nvalid bound, and rows past the walked chunks are zero."""
    rng = np.random.default_rng(3)
    n = 3000
    means = torch.from_numpy(np.stack(
        [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
         rng.uniform(1.0, 1.3, n)], -1).astype(np.float32))
    scales = torch.full((n, 3), 0.4)
    quats = torch.tensor([1.0, 0, 0, 0]).repeat(n, 1)
    opac = torch.full((n,), 0.98)
    colors = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    cam = TCamera(**CAMKW)
    prep = tpreprocess(means[None], scales, quats, cam)
    bins = ttile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                     cam.width, cam.height, TILE, K)
    packed = cuda_fisher.pack_fisher_features(prep, bins, opac, colors,
                                              means[None])
    pix_xy = torch.stack(ttile_pixel_coords(bins.n_tiles_x, bins.n_tiles_y,
                                            TILE), dim=1)
    nvalid = bins.slot_valid.sum(-1, dtype=torch.int32)[0]
    h, k_eff = cuda_fisher._fisher_walk(packed[0], pix_xy, nvalid, CHUNK,
                                        GV, cam.fx, cam.fy)
    assert torch.isfinite(h).all() and h.sum() > 0
    assert (k_eff < (nvalid + CHUNK - 1) // CHUNK).any()
    for r in range(h.shape[0]):
        assert (h[r, int(k_eff[r]) * CHUNK:] == 0).all()


def test_fisher_wrapper_rejects_unsupported_device():
    packed = torch.zeros(1, 1, K, 11, device="meta")
    pix_xy = torch.zeros(1, 2, 256, device="meta")
    nvalid = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_fisher.cuda_fisher_slots(packed, pix_xy, nvalid, CHUNK, GV,
                                      32.0, 32.0)
