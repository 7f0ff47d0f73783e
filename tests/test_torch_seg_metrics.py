"""engine/seg_metrics.py, the port's copy, against the JAX package's on
the same random label grids: equal (both are numpy)."""
import numpy as np
import pytest

from fisher_nerf_customized_tpu.engine import seg_metrics as jseg
from fisher_nerf_customized_tpu_torch.engine import seg_metrics as tseg


@pytest.mark.parametrize("n_classes,seed", [(2, 0), (3, 1), (5, 2)])
def test_seg_metrics_equal_jax(n_classes, seed):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, n_classes, (40, 50))
    pred = np.where(rng.uniform(size=target.shape) < 0.7, target,
                    rng.integers(0, n_classes, target.shape))
    if n_classes == 5:
        pred[pred == 4] = 0          # a class never predicted
        target[target == 4] = 0      # and absent: NaN IoU, skipped
    assert tseg.pixel_accuracy(pred, target) == \
        jseg.pixel_accuracy(pred, target)
    for fn in ("confusion_matrix", "iou_per_class", "f1_per_class"):
        np.testing.assert_array_equal(getattr(tseg, fn)(pred, target,
                                                        n_classes),
                                      getattr(jseg, fn)(pred, target,
                                                        n_classes))
    for fn in ("mean_iou", "mean_f1"):
        assert getattr(tseg, fn)(pred, target, n_classes) == \
            getattr(jseg, fn)(pred, target, n_classes)
