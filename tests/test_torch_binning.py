"""Tile binning when a depth tie straddles the K cut: the port's tile_bin
keeps the same Gaussians, in the same slots, as the JAX package's
(lax.top_k keeps the lowest indices among the scores tied at the k-th
place).  Batch 1 only: the JAX package's vmapped top_k orders ties by
batch size (ROADMAP.md, queue 3 item i).  Table, slot_valid, counts and
overflow must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.ops.binning import tile_bin as jtile_bin
from fisher_nerf_customized_tpu_torch.ops.binning import _nearest_k
from fisher_nerf_customized_tpu_torch.ops.binning import tile_bin as ttile_bin


def assert_same_bins(mean2d, radius, depth, valid, width, height, tile, k):
    ref = jtile_bin(jnp.asarray(mean2d), jnp.asarray(radius),
                    jnp.asarray(depth), jnp.asarray(valid), width, height,
                    tile, k)
    got = ttile_bin(torch.from_numpy(mean2d), torch.from_numpy(radius),
                    torch.from_numpy(depth), torch.from_numpy(valid), width,
                    height, tile, k)
    np.testing.assert_array_equal(got.slot_valid.numpy(),
                                  np.asarray(ref.slot_valid))
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert int(got.overflow) == int(ref.overflow)
    return got


def test_tie_across_the_fine_cut():
    """64x64, tile 16, K 256: 600 Gaussians in tile 0, 200 at depth 1.0
    and 400 at 2.0 in shuffled index order, so 56 of the 400 tied at the
    cut are kept."""
    rng = np.random.default_rng(0)
    n = 600
    depth = np.where(rng.permutation(n) < 200, 1.0, 2.0).astype(np.float32)
    mean2d = rng.uniform(2.0, 14.0, (n, 2)).astype(np.float32)
    radius = np.full(n, 1.0, np.float32)
    valid = np.ones(n, bool)
    got = assert_same_bins(mean2d, radius, depth, valid, 64, 64, 16, 256)
    kept = got.table[0].numpy()
    tied = np.flatnonzero(depth == 2.0)
    np.testing.assert_array_equal(np.sort(kept[200:]), tied[:56])


@pytest.mark.parametrize("k", [4, 8])
def test_tie_across_the_coarse_and_fine_cuts(k):
    """128x128, tile 16 (8x8 tiles in 2x2 coarse cells): 300 Gaussians in
    the first coarse cell at three depths, more than Kc = 8 K of them
    tied at the coarse cut and more than K at the fine cut."""
    rng = np.random.default_rng(1)
    n = 300
    depth = rng.choice(np.asarray([1.0, 2.0, 3.0], np.float32), n,
                       p=[0.02, 0.3, 0.68]).astype(np.float32)
    mean2d = rng.uniform(4.0, 60.0, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.5, 12.0, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    got = assert_same_bins(mean2d, radius, depth, valid, 128, 128, 16, k)
    assert int(got.overflow) > 0


@pytest.mark.parametrize("seed", range(4))
def test_random_integer_depths(seed):
    """Depths from five values over a hierarchical grid: ties at most
    cuts."""
    rng = np.random.default_rng(10 + seed)
    n = 400
    depth = rng.integers(1, 6, n).astype(np.float32)
    mean2d = rng.uniform(-10.0, 140.0, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.5, 30.0, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    assert_same_bins(mean2d, radius, depth, valid, 128, 128, 16, 8)


def test_nearest_k_order_and_set():
    """_nearest_k against a (score desc, index asc) sort, with -inf rows
    and rows shorter than k."""
    rng = np.random.default_rng(3)
    scores = rng.integers(-3, 3, (50, 40)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.2] = -np.inf
    for k in (5, 17, 40, 45):
        idx, valid = _nearest_k(torch.from_numpy(scores), k)
        for row, got, ok in zip(scores, idx.numpy(), valid.numpy()):
            padded = np.concatenate([row, np.full(max(k - len(row), 0),
                                                  -np.inf, np.float32)])
            order = np.lexsort((np.arange(len(padded)), -padded))[:k]
            np.testing.assert_array_equal(got, np.minimum(order,
                                                          len(row) - 1))
            np.testing.assert_array_equal(ok, padded[order] > -np.inf)
