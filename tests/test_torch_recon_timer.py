"""The recon update's sub-phases in the episode's StepTimer
(engine/eval.py::IncrementalReconMetric.update with a timer,
engine/driver.py::ActiveMapper._recon_update), on the CPU: the phases a
CPU run reaches are recorded under recon_metric, and timing changes no
result (equal, not close).  The card's sub-phases (.upload, .nn1,
.download, .recompute) are reached only by a CUDA device; chip_smoke.py
reports them from the episode.
"""
import numpy as np
import pytest

from fisher_nerf_customized_tpu_torch.engine import eval as teval
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene
from fisher_nerf_customized_tpu_torch.utils.logging_utils import StepTimer


def case(seed):
    scene = BoxScene.multi_room(seed=seed)
    rng = np.random.default_rng(seed)
    gt = scene.sample_surface_points(20_000, rng=rng).astype(np.float32)
    parts = [(scene.sample_surface_points(n, rng=rng)
              + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
             for n in (900, 0, 1500)]
    return scene, gt, parts


@pytest.mark.parametrize("surface", [False, True])
def test_update_records_its_sub_phases(surface):
    scene, gt, parts = case(4)
    fn = scene.surface_distance if surface else None
    timed = teval.IncrementalReconMetric(gt, 0.05, surface_dist_fn=fn)
    plain = teval.IncrementalReconMetric(gt, 0.05, surface_dist_fn=fn)
    timer = StepTimer()
    for part in parts:
        assert timed.update(part, timer=timer) == plain.update(part)
    counts = timer.summary()
    first = "recon_metric.surface" if surface else "recon_metric.ckdtree"
    assert counts[first]["count"] == (2 if surface else 4)
    assert counts["recon_metric.ckdtree"]["count"] >= 2
    # two non-empty parts (the minimum and the means) and the empty one
    # (the means)
    assert counts["recon_metric.running_min"]["count"] == 5
    assert all(k.startswith("recon_metric.") for k in counts)
