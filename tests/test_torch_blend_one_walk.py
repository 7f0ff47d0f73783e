"""K2's one-walk algebra and K1's rows-walked output, on the CPU.

The K2 kernel (csrc/blend_bwd.cu) walks each tile once and takes from
K1's outputs what the twin computes in its own first pass and suffix sums:
the stop (K1's rows walked), g_t T_final (K1's final T) and S_behind,i =
gcol . (C_final - C_incl,i).  `cuda_blend_bwd.blend_bwd_one_walk` is that
algebra in plain PyTorch; it is held here against the K2 twin
`blend_bwd_plain` and against the JAX package's Pallas backward in
interpret mode, on the scenes of tests/test_torch_blend_bwd.py and at its
tolerance (rtol 1e-3 plus 1e-5 of each output column's largest value:
C_final - C_incl cancels where the twin sums a suffix directly).  K1's
rows walked (`cuda_blend` on the CPU) are held against the Pallas
forward's stop, read off by re-running it with nvalid cut chunk by chunk.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops.pallas_blend import pallas_blend
from fisher_nerf_customized_tpu.ops.pallas_blend_bwd import (
    pallas_blend_bwd_slots)
from fisher_nerf_customized_tpu_torch.ops import cuda_blend, cuda_blend_bwd

import test_torch_blend as fwd_scenes
from test_torch_blend_bwd import CHUNK, K, assert_close_per_column, scene

SEEDS = {"random": 0, "opaque_wall": 2, "corner": 5}


def _one_walk(kind, n_ch=4):
    packed, pix_xy, nvalid, gcol, g_t = (torch.from_numpy(x) for x in scene(
        kind, SEEDS[kind], n_ch))
    (color, t_final, _med), walked = cuda_blend.cuda_blend(
        packed, pix_xy, nvalid, CHUNK, 15.0)
    got = cuda_blend_bwd.blend_bwd_one_walk(packed, pix_xy, gcol, g_t, nvalid,
                                            color, t_final, walked)
    return got, (packed, pix_xy, gcol, g_t, nvalid), walked


@pytest.mark.parametrize("kind", ["random", "opaque_wall", "corner"])
def test_one_walk_matches_the_k2_twin(kind):
    got, args, walked = _one_walk(kind)
    ref = cuda_blend_bwd.blend_bwd_plain(*args, CHUNK)
    assert got.shape == ref.shape == (args[0].shape[0], K, 10)
    assert_close_per_column(got.numpy(), ref.numpy(), 1e-3, 1e-5)
    # past the forward's stop or past nvalid: exactly zero
    n_walk = torch.minimum(walked, args[4].long())
    past = torch.arange(K)[None, :] >= n_walk[:, None]
    assert (got[past] == 0).all()
    if kind == "opaque_wall":        # the stop cuts valid rows
        assert (walked < args[4]).any()


@pytest.mark.parametrize("kind", ["random", "opaque_wall", "corner"])
def test_one_walk_matches_pallas_interpret(kind):
    got, (packed, pix_xy, gcol, g_t, nvalid), _walked = _one_walk(kind)
    packed = packed.numpy()
    # the Pallas kernel's layout: no valid column, validity folded into
    # the opacity
    packed_j = np.concatenate([packed[..., :7], packed[..., 8:]], axis=-1)
    packed_j[..., 5] *= packed[..., 7]
    ref = np.asarray(pallas_blend_bwd_slots(
        jnp.asarray(packed_j), jnp.asarray(pix_xy.numpy()),
        jnp.asarray(gcol.numpy()), jnp.asarray(g_t.numpy())[:, None, :],
        jnp.asarray(nvalid.numpy()), CHUNK, interpret=True))
    assert_close_per_column(got.numpy(), ref, 1e-3, 1e-5)


@pytest.mark.parametrize("kind", ["random", "opaque_wall", "corner"])
def test_rows_walked_equal_the_pallas_forward_stop(kind):
    """Pallas walks chunk m + 1 iff m < ceil(nvalid / chunk) and the max of
    T after m chunks is >= 1e-4; T after m chunks is its final T with
    nvalid cut to m chunks."""
    chunk, k = fwd_scenes.CHUNK, fwd_scenes.K
    packed, pix_xy, nvalid = fwd_scenes.scene(kind, SEEDS[kind], 4)
    n_chunks = (nvalid + chunk - 1) // chunk
    stop = np.full(len(nvalid), -1)
    for m in range(k // chunk + 1):
        cut = np.minimum(nvalid, m * chunk).astype(np.int32)
        _c, t_m, _z = pallas_blend(jnp.asarray(packed), jnp.asarray(pix_xy),
                                   jnp.asarray(cut), fwd_scenes.TILE, k,
                                   chunk=chunk, max_depth=15.0,
                                   interpret=True)
        ends = (m >= n_chunks) | (np.asarray(t_m).max(axis=-1) < 1e-4)
        stop = np.where((stop < 0) & ends, m, stop)
    assert (stop >= 0).all()
    _out, walked = cuda_blend.cuda_blend(
        *(torch.from_numpy(np.array(x)) for x in (packed, pix_xy, nvalid)),
        chunk, 15.0)
    np.testing.assert_array_equal(walked.numpy(), stop * chunk)
    if kind == "opaque_wall":
        assert (stop < n_chunks).any()
