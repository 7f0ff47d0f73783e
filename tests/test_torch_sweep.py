"""The port's sweep tool (tools/multi_scene_sweep.py) against the JAX
package's scripts (multi_scene_sweep.py, quality_check.py): the same
config, the same reference-shaped YAML; and one small sweep on the CPU
(48x48, 10 steps, both policies, one scene, small overrides) writing
the YAMLs, the cells and auc_summary.json, then read back from its
cache."""
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)

from fisher_nerf_customized_tpu_torch.engine.eval import MetricsRecorder
from fisher_nerf_customized_tpu_torch.tools import multi_scene_sweep as tsweep

REF_STEP_KEYS = {"step", "acc_distance_m", "comp_distance_m",
                 "completeness_ratio", "fpr", "est_pcl_path"}
SMALL = ["--set", "mapping.num_iters", "4", "tpu.capacity", "8192",
         "tpu.tile_size", "8", "tpu.max_per_tile", "512", "map_every", "4",
         "--set", "policy.planning_queue_size", "10",
         "explore.sample_view_num", "32", "tpu.pose_chunk", "4"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_config_is_quality_checks(tmp_path):
    from quality_check import build
    from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene
    jm, _scene = build("gaussians_based", 1000, seed=105,
                       workdir=str(tmp_path), run_name="x",
                       scene=BoxScene.multi_room(seed=105))
    ref = flat(jm.cfg.to_dict())
    got = flat(tsweep.build_config("gaussians_based", 1000, str(tmp_path),
                                   "x").to_dict())
    shared = ref.keys() & got.keys()
    assert len(shared) > 100
    assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}


def test_reference_yaml_is_the_scripts(tmp_path):
    from multi_scene_sweep import dump_reference_yaml
    rec = MetricsRecorder("gaussians_based", "fake_apartment_105")
    for t in (0, 25, 50):
        rec.record(t, acc_distance=0.0015, comp_distance=2.0 - t / 50,
                   completeness_ratio=t * 0.4, fpr=0.0)
    paths = [str(tmp_path / "j" / "a.yaml"), str(tmp_path / "t" / "a.yaml")]
    dump_reference_yaml(rec, paths[0], "fake_apartment_105", 0.05)
    tsweep.dump_reference_yaml(rec, paths[1], "fake_apartment_105", 0.05)
    assert open(paths[0]).read() == open(paths[1]).read()


def test_small_sweep_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "sweep"
    argv = ["--policies", "gaussians_based,frontier", "--scene_seeds", "3",
            "--steps", "10", "--img", "48", "--device", "cpu",
            "--out", str(out)] + SMALL
    summary = tsweep.main(argv)
    md = out / "metric_data"
    for name in ("FisherRF", "FBE"):
        doc = yaml.safe_load(open(md / name / "fake_apartment_3.yaml"))
        assert doc["experiment"] == dict(policy_name=name,
                                         scene_id="fake_apartment_3")
        assert doc["settings"]["distance_threshold_m"] == 0.05
        assert [s["step"] for s in doc["steps"]] == [0]
        assert set(doc["steps"][0]) == REF_STEP_KEYS
    for policy in ("gaussians_based", "frontier"):
        cell = json.load(open(out / "cells"
                              / f"{policy}_fake_apartment_3.json"))
        assert cell["steps"] == 10
        assert cell["result"]["timing"]["recon_metric"]["count"] == 1
    saved = json.load(open(md / "auc_summary.json"))
    assert saved == json.loads(json.dumps(summary))
    assert set(saved["policies"]) == {"FisherRF", "FBE"}
    assert saved["paired_FisherRF_vs_FBE"]["per_scene_delta"].keys() == {
        "fake_apartment_3"}
    # a finished cell's YAML is its cache
    capsys.readouterr()
    again = tsweep.main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"policy"')]
    assert len(lines) == 2 and all(ln["cached"] for ln in lines)
    for name, pol in saved["policies"].items():
        np.testing.assert_allclose(again["policies"][name]["auc_mean"],
                                   pol["auc_mean"], rtol=1e-12)
