"""run.py refuses to run without a card, and a run's check comes out
false when the timed path is broken underneath (on the CPU, at a small
size: the harness's look for a card is skipped, the rest of a run is
driven as on the card)."""
import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SMALL = dict(img_size=64, overrides={"tpu.capacity": 16384,
                                     "mapping.num_iters": 4,
                                     "explore.sample_view_num": 32})
SMALL_PARAMS = {"eccv_eval": dict(map_steps=20),
                "eccv_plan": dict(map_steps=20)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_run(cell, seed=1234567890123, control=False, overrides=None):
    import run
    conf = SMALL if not overrides else dict(
        SMALL, overrides=dict(SMALL["overrides"], **overrides))
    r, metrics = run.run_cell(cell, seed, 2.0, False, device="cpu",
                              config_patch=conf, control=control,
                              params_patch=SMALL_PARAMS.get(cell))
    return r, metrics


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for a machine without")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "eccv_episode", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.parametrize("cell", ["eccv_episode", "eccv_eval", "eccv_plan"])
def test_sound_run_correct_and_control_fails(cell):
    """The program passes its own check, and the control (the reference
    one precision below) fails at least one of the cell's numbers."""
    r, metrics = small_run(cell, control=True)
    assert r.correct, r.checks
    assert "setup_s" in metrics
    assert any(r.control_checks[n] > lim for n, _v, lim in r.checks
               if n in r.control_checks), (r.control_checks, r.checks)
    json.dumps(metrics)


def _fault_unchanged_step(monkeypatch):
    import fisher_nerf_customized_tpu_torch.models.slam as slam_mod
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        adam_step)

    def stuck(opt, params, grads, lrs, *a, **kw):
        _new, opt2 = adam_step(opt, params, grads, lrs, *a, **kw)
        return {k: v.detach().clone() for k, v in params.items()}, opt2
    monkeypatch.setattr(slam_mod, "adam_step", stuck)


def _fault_half_batch(monkeypatch):
    import fisher_nerf_customized_tpu_torch.models.slam as slam_mod
    phase0 = slam_mod._mapping_phase_impl

    def half(state, c, d, w, choices, *a, **kw):
        import numpy as np
        choices = np.asarray(choices)
        return phase0(state, c, d, w, choices[:, :choices.shape[1] // 2],
                      *a, **kw)
    monkeypatch.setattr(slam_mod, "_mapping_phase_impl", half)


# Four frames a step, so that the first mapping event's first step draws
# different frames (at two, the set-up's event draws one frame twice and
# half of it is the whole): the check then has such a step to compare
# however few events the two-second window reaches.
_fault_half_batch.overrides = {"tpu.mapping_frames_per_iter": 4}


def _fault_render_altered(monkeypatch):
    from fisher_nerf_customized_tpu_torch.ops import rasterize
    blend0 = rasterize.cuda_blend

    def altered(*a, **kw):
        (color, t, med), walked = blend0(*a, **kw)
        return (color * 1.01, t, med), walked
    monkeypatch.setattr(rasterize, "cuda_blend", altered)


def _fault_scores_altered(monkeypatch):
    from fisher_nerf_customized_tpu_torch.ops import fisher
    f0 = fisher.cuda_fisher_slots

    def altered(*a, **kw):
        return f0(*a, **kw) * 1.01
    monkeypatch.setattr(fisher, "cuda_fisher_slots", altered)


@pytest.mark.parametrize("cell,fault", [
    ("eccv_episode", _fault_unchanged_step),
    ("eccv_episode", _fault_half_batch),
    ("eccv_episode", _fault_render_altered),
    ("eccv_eval", _fault_render_altered),
    ("eccv_plan", _fault_scores_altered),
], ids=["episode-unchanged-step", "episode-half-batch",
        "episode-render-altered", "eval-render-altered",
        "plan-scores-altered"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    r, _m = small_run(cell, overrides=getattr(fault, "overrides", None))
    assert not r.correct, r.checks


@pytest.mark.card
def test_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "eccv_episode", "--seed", "5", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
