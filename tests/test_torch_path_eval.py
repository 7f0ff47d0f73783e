"""Path EIG, JAX package (engine "xla") against the PyTorch port on the
CPU: the map of tests/test_torch_slice.py (64x64 FakeSim frames, init +
densify), its H_train, and 20 padded paths of up to 30 actions rolled
out from the last frame's pose, scored at the acc steps 3, 8, ..., 28.

Tolerances: scores to rtol 1e-2, as the slice's H_train (the JAX
package's XLA engine never stops a tile early; the port's twin stops at
T < 1e-4 as K3 does); the same ranking (Spearman >= 0.99) and the same
argmax.  The path batch is 20 poses, never the 2-pose batch of
ROADMAP.md queue 3 item i.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

import test_torch_slice as slice_test
from fisher_nerf_customized_tpu.engine import path_eval as jpe
from fisher_nerf_customized_tpu_torch.engine import path_eval as tpe
from fisher_nerf_customized_tpu_torch.engine.actions import (
    rollout_path_poses)

built = slice_test.built          # the module-scoped map fixture
QUEUE = 30
ACC_EVERY = 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under the suite's six
    workers, torch's default of one thread per core oversubscribes the
    CPU beside XLA's own pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_acc_step_indices_match():
    for n, k in ((30, 5), (8, 5), (12, 3), (4, 7)):
        assert tpe.acc_step_indices(n, k) == jpe.acc_step_indices(n, k)
    assert tpe.acc_step_indices(QUEUE, ACC_EVERY) == [3, 8, 13, 18, 23, 28]


def path_inputs(c2w, n_paths, seed):
    """(w2cs (20, A', 4, 4), valid, lengths, final_eigs) as the driver
    builds them for n_paths random action lists."""
    rng = np.random.default_rng(seed)
    acc = tpe.acc_step_indices(QUEUE, ACC_EVERY)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (20, len(acc), 1, 1))
    valid = np.zeros((20, len(acc)), bool)
    lengths = np.ones((20,), np.int32)
    final = np.full((20,), -np.inf, np.float32)
    for i in range(n_paths):
        acts = rng.choice([1, 1, 2, 3], int(rng.integers(4, QUEUE + 1)))
        poses = rollout_path_poses(c2w, acts.tolist(), 1.25, 0.15, 20.0)
        for j, s in enumerate(acc):
            if s < len(acts):
                w2cs[i, j] = np.linalg.inv(poses[s])
                valid[i, j] = True
        lengths[i] = len(acts)
        final[i] = np.log(rng.uniform(0.5, 2.0))
    return w2cs, valid, lengths, final


@pytest.mark.parametrize("end_weight,vol_weighted,n_paths",
                         [(30.0, False, 20), (0.0, False, 13),
                          (0.0, True, 7)])
def test_path_eig_scores_match_jax(built, end_weight, vol_weighted, n_paths):
    js, ts = built["js"], built["ts"]
    c2w = np.linalg.inv(built["frames"][-1][2]).astype(np.float64)
    w2cs, valid, lengths, final = path_inputs(c2w, n_paths, seed=n_paths)
    lam, pose_w, point_w = 1e-6, 0.2, 1.0
    ref = jpe.path_eig_scores(
        js.state, js.compute_H_train(), jnp.asarray(w2cs),
        jnp.asarray(valid), jnp.asarray(lengths), jnp.asarray(final),
        js.fisher_camera, js.fisher_settings, lam, pose_w, point_w,
        end_weight, vol_weighted, float(js.gs_pts_cnt()), engine="xla",
        grad_value=js.fisher_grad_value)
    got = tpe.path_eig_scores(
        ts.state, ts.compute_H_train(), torch.from_numpy(w2cs),
        torch.from_numpy(valid), torch.from_numpy(lengths),
        torch.from_numpy(final), ts.fisher_camera, ts.fisher_settings, lam,
        pose_w, point_w, end_weight, vol_weighted, float(ts.gs_pts_cnt()),
        grad_value=ts.fisher_grad_value)
    ref = np.asarray(ref)[:n_paths]
    got = got.numpy()[:n_paths]
    assert np.isfinite(got).all() and got.std() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-2)
    assert int(np.argmax(got)) == int(np.argmax(ref))
    assert spearmanr(got, ref).correlation >= 0.99
