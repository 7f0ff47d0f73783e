"""K3's two-forward-walk algebra on the CPU.

The K3 kernel (csrc/fisher.cu) walks each (pose, tile) front to back
twice: the first walk stops the tile and totals C = sum alpha T csum per
pixel, the second forms S_behind = C - run from the inclusive prefix run.
`cuda_fisher.fisher_one_walk` is that algebra in plain PyTorch; it is held
here against the twin `fisher_slots_plain` (forward walk, then a reverse
walk over suffix sums) and against the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs: a sparse scene and a saturating
one whose tiles stop before nvalid, at the 11- and 20-wide packings.
Tolerance rtol 5e-3 / atol 1e-8, as in tests/test_torch_fisher.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops.pallas_fisher import pallas_fisher_slots
from fisher_nerf_customized_tpu_torch.ops import cuda_fisher
from fisher_nerf_customized_tpu_torch.ops.camera import Camera
from fisher_nerf_customized_tpu_torch.ops.fisher import fisher_kernel_inputs
from fisher_nerf_customized_tpu_torch.ops.rasterize import RenderSettings

from test_torch_fisher import CAMKW, CHUNK, GV, K, TILE
from test_torch_fisher import scene as sparse_scene

FX = FY = CAMKW["fx"]


def saturating_scene(seed=3, n=3000):
    """A dense opaque wall in front of the camera (the stop test's scene)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(1.0, 1.3, n)], -1).astype(np.float32)
    scales = np.full((n, 3), 0.4, np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    opac = np.full(n, 0.98, np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def kernel_inputs(kind, full_chain):
    """(packed (2, T, K, NF), pix_xy (T, 2, P), nvalid (2, T)) as numpy, two
    poses, from the port's preprocess, binning and packing."""
    gaussians = sparse_scene(7) if kind == "sparse" else saturating_scene()
    w2cs = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    w2cs[1, 0, 3] = 0.3
    packed, pix_xy, nvalid, _bins, _prep = fisher_kernel_inputs(
        Camera(**CAMKW), torch.from_numpy(w2cs),
        *(torch.from_numpy(x) for x in gaussians),
        settings=RenderSettings(tile_size=TILE, max_per_tile=K, chunk=CHUNK),
        full_chain=full_chain)
    return packed.numpy(), pix_xy.numpy(), nvalid.numpy()


def one_walk(packed, pix_xy, nvalid):
    return cuda_fisher.fisher_one_walk(
        *(torch.from_numpy(x) for x in (packed, pix_xy, nvalid)), CHUNK, GV,
        FX, FY).numpy()


@pytest.mark.parametrize("kind", ["sparse", "saturating"])
@pytest.mark.parametrize("full_chain", [False, True])
def test_one_walk_matches_the_twin(kind, full_chain):
    packed, pix_xy, nvalid = kernel_inputs(kind, full_chain)
    assert packed.shape[-1] == (20 if full_chain else 11)
    args = [torch.from_numpy(x) for x in (packed, pix_xy, nvalid)]
    ref = cuda_fisher.fisher_slots_plain(*args, CHUNK, GV, FX, FY).numpy()
    got = one_walk(packed, pix_xy, nvalid)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=1e-8)
    # rows past the tile's stop are exactly zero in both
    nb, n_tiles, k, nf = packed.shape
    _h, k_eff = cuda_fisher._fisher_walk(args[0].reshape(-1, k, nf), args[1],
                                         args[2].reshape(-1), CHUNK, GV, FX,
                                         FY)
    past = np.arange(k)[None, :] >= (k_eff.numpy() * CHUNK)[:, None]
    assert (got.reshape(-1, k, 4)[past] == 0).all()
    if kind == "saturating":          # the stop cuts valid rows
        assert (k_eff.numpy() < (nvalid.reshape(-1) + CHUNK - 1) // CHUNK).any()


@pytest.mark.parametrize("kind", ["sparse", "saturating"])
@pytest.mark.parametrize("full_chain", [False, True])
def test_one_walk_matches_pallas_interpret(kind, full_chain):
    packed, pix_xy, nvalid = kernel_inputs(kind, full_chain)
    got = one_walk(packed, pix_xy, nvalid)
    for b in range(packed.shape[0]):
        ref = np.asarray(pallas_fisher_slots(
            jnp.asarray(packed[b]), jnp.asarray(pix_xy),
            jnp.asarray(nvalid[b]), CHUNK, GV, FX, FY, interpret=True))
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got[b], ref, rtol=5e-3, atol=1e-8)


@pytest.mark.parametrize("plain", ["twin", "one_walk"])
@pytest.mark.parametrize("full_chain", [False, True])
def test_nan_opacity_row_blends_nowhere(plain, full_chain):
    """A row whose opacity is NaN fails the 1/255 test at every pixel: its
    own row of h is 0 and every other row is as if its opacity were 0."""
    packed, pix_xy, nvalid = kernel_inputs("sparse", full_chain)
    fn = (cuda_fisher.fisher_slots_plain if plain == "twin"
          else cuda_fisher.fisher_one_walk)
    b, t = np.unravel_index(np.argmax(nvalid), nvalid.shape)
    nan_rows, zero_rows = packed.copy(), packed.copy()
    nan_rows[b, t, 1, 5] = np.nan
    zero_rows[b, t, 1, 5] = 0.0
    got, ref = (fn(*(torch.from_numpy(x) for x in (rows, pix_xy, nvalid)),
                   CHUNK, GV, FX, FY).numpy() for rows in (nan_rows, zero_rows))
    assert (got[b, t, 1] == 0).all()
    np.testing.assert_array_equal(got, ref)
