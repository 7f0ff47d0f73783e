"""The tracked_episode cell on the CPU at a small size: the sound program
passes its check and the control fails the three tracking limits; the
check comes out false when the pose gradient the tracking step is given
is scaled, or when the port's loss leaves the silhouette mask out."""
import pytest
import torch

SMALL = dict(img_size=64, overrides={"tpu.capacity": 16384,
                                     "mapping.num_iters": 4,
                                     "explore.sample_view_num": 32,
                                     "tracking.num_iters": 4})
TRACKING = ("tracking_loss_gap", "tracking_grad_gap", "tracking_step_gap")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_run(control=False):
    import run
    return run.run_cell("tracked_episode", 1234567890123, 2.0, False,
                        device="cpu", config_patch=SMALL, control=control)


def test_sound_run_correct_and_control_fails_tracking():
    r, metrics = small_run(control=True)
    assert r.correct, r.checks
    assert {"setup_s", "steps_per_s"} <= set(metrics)
    assert r.values["tracked_frames"] > 0
    limits = {n: lim for n, _v, lim in r.checks}
    for n in TRACKING:
        assert r.control_checks[n] > limits[n], (n, r.control_checks)


def _fault_scaled_gradient(monkeypatch):
    """The loss's value kept, its gradient to the pose scaled by 1.01."""
    import fisher_nerf_customized_tpu_torch.models.slam as slam_mod
    loss0 = slam_mod._tracking_loss

    def scaled(*a, **kw):
        loss, depth_l = loss0(*a, **kw)
        return loss.detach() + 1.01 * (loss - loss.detach()), depth_l
    monkeypatch.setattr(slam_mod, "_tracking_loss", scaled)


def _fault_no_silhouette(monkeypatch):
    import fisher_nerf_customized_tpu_torch.models.slam as slam_mod
    loss0 = slam_mod._tracking_loss

    def unmasked(*a, **kw):
        *head, tc = a
        return loss0(*head, tc._replace(use_sil_for_loss=False), **kw)
    monkeypatch.setattr(slam_mod, "_tracking_loss", unmasked)


@pytest.mark.parametrize("fault", [_fault_scaled_gradient,
                                   _fault_no_silhouette],
                         ids=["scaled-gradient", "no-silhouette"])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r, _m = small_run()
    assert not r.correct, r.checks
    assert any(v > lim for n, v, lim in r.checks if n in TRACKING), r.checks
