"""K1 plain twin (the port's forward blend on the CPU) against the JAX
package's Pallas blend kernel in interpret mode, on identical packed
inputs.  Tolerances are those of tests/test_pallas_blend.py: color and
final T atol 3e-4, median depth atol 1e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops.binning import tile_bin
from fisher_nerf_customized_tpu.ops.camera import Camera
from fisher_nerf_customized_tpu.ops.pallas_blend import (pack_tile_params,
                                                         pallas_blend)
from fisher_nerf_customized_tpu.ops.projection import preprocess
from fisher_nerf_customized_tpu.ops.rasterize import tile_pixel_coords
from fisher_nerf_customized_tpu_torch.ops import cuda_blend

CAM = Camera(fx=64.0, fy=64.0, cx=32.0, cy=32.0, width=64, height=64)
TILE, K, CHUNK = 16, 128, 32


def scene(kind, seed, n_ch):
    rng = np.random.default_rng(seed)
    if kind == "random":
        n = 400
        means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                          rng.uniform(1.0, 6.0, n)], -1)
        scales = rng.uniform(0.03, 0.15, (n, 3))
        opac = rng.uniform(0.2, 0.95, n)
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
        opac = rng.uniform(0.3, 0.9, n)
    quats = rng.normal(size=(n, 4))
    colors = rng.uniform(0, 1, (n, n_ch))
    f32 = [np.asarray(x, np.float32) for x in (means, scales, quats, opac,
                                               colors)]
    means, scales, quats, opac, colors = (jnp.asarray(x) for x in f32)
    prep = preprocess(means, scales, quats, CAM)
    bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                    CAM.width, CAM.height, TILE, K)
    packed = np.array(pack_tile_params(prep, bins, opac, colors))
    pix_x, pix_y = tile_pixel_coords(bins.n_tiles_x, bins.n_tiles_y, TILE)
    pix_xy = np.asarray(jnp.stack([pix_x, pix_y], axis=1))
    nvalid = np.asarray(bins.slot_valid).sum(-1).astype(np.int32)
    return packed, pix_xy, nvalid


@pytest.mark.parametrize("kind", ["random", "opaque_wall", "corner"])
@pytest.mark.parametrize("n_ch", [4, 5])
def test_blend_plain_matches_pallas_interpret(kind, n_ch):
    packed, pix_xy, nvalid = scene(kind, {"random": 0, "opaque_wall": 2,
                                          "corner": 5}[kind], n_ch)
    if kind == "corner":
        assert (nvalid == 0).sum() >= len(nvalid) // 2
    ref = pallas_blend(jnp.asarray(packed), jnp.asarray(pix_xy),
                       jnp.asarray(nvalid), TILE, K, chunk=CHUNK,
                       max_depth=15.0, interpret=True)
    got, _walked = cuda_blend.cuda_blend(
        *(torch.from_numpy(np.array(x)) for x in (packed, pix_xy, nvalid)),
        CHUNK, 15.0)
    for g, r, atol in zip(got, ref, (3e-4, 3e-4, 1e-2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)


def test_blend_walk_stops_early_on_saturated_tiles():
    """The opaque wall saturates its tiles within the first chunk: the
    walk must stop there instead of walking every valid row."""
    packed, pix_xy, nvalid = scene("opaque_wall", 2, 4)
    _out, walked = cuda_blend._blend_walk(
        *(torch.from_numpy(np.array(x)) for x in (packed, pix_xy, nvalid)),
        CHUNK, 15.0)
    bound = (nvalid + CHUNK - 1) // CHUNK * CHUNK
    assert (walked.numpy() < bound).any()
    assert (walked.numpy() <= bound).all()


def test_blend_wrapper_rejects_unsupported_device():
    packed, pix_xy, nvalid = scene("random", 0, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_blend.cuda_blend(*(torch.from_numpy(np.array(x)).to("meta")
                                for x in (packed, pix_xy, nvalid)), CHUNK)


def test_blend_kernel_inputs_match_jax_packing():
    """The port's K1 packing has the JAX pack_tile_params layout:
    [mu (2), conic (3), opacity, depth, valid, colors] per valid slot."""
    from fisher_nerf_customized_tpu_torch.ops import binning as tbin
    from fisher_nerf_customized_tpu_torch.ops import projection as tproj
    from fisher_nerf_customized_tpu_torch.ops import rasterize as tras
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCam
    rng = np.random.default_rng(6)
    n = 300
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(1.0, 6.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.03, 0.15, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 5)).astype(np.float32)
    jargs = [jnp.asarray(x) for x in (means, scales, quats)]
    prep = preprocess(*jargs, CAM)
    bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                    CAM.width, CAM.height, TILE, K)
    ref = np.asarray(pack_tile_params(prep, bins, jnp.asarray(opac),
                                      jnp.asarray(colors)))
    tcam = TCam(*CAM[:6])
    tprep = tproj.preprocess(*(torch.from_numpy(x) for x in
                               (means, scales, quats)), tcam)
    tb = tbin.tile_bin(tprep.mean2d, tprep.radius, tprep.depth, tprep.valid,
                       CAM.width, CAM.height, TILE, K)
    st = tras.RenderSettings(tile_size=TILE, max_per_tile=K, chunk=CHUNK)
    got, _pix, nvalid = tras.blend_kernel_inputs(
        st, tprep, tb, torch.from_numpy(opac), torch.from_numpy(colors))
    sv = np.asarray(bins.slot_valid)
    np.testing.assert_array_equal(nvalid.numpy(), sv.sum(-1))
    np.testing.assert_allclose(got.numpy()[sv], ref[sv], rtol=1e-5, atol=1e-6)
    assert (got.numpy()[~sv][:, 7] == 0).all()
