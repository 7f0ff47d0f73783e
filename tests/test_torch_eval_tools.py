"""The port's evaluation tools (fisher_nerf_customized_tpu_torch/tools/)
against the JAX package's scripts/ on the same files, on the CPU; the
scripts run in their own processes (JAX on the CPU), the tools in this
one.  Fixtures: a port episode's output at 48x48 (8 steps, run once per
module), seeded PNG pairs and clouds.  Also utils/raster.py::read_png
against cv2.imread, and the two scripts that import neither package
(compare_curves.py, print_results.py) on the port episode's output.

Tolerances: the JSON of eval_render rtol 1e-5 (PSNR and SSIM summed in
f32 in other orders); of eval_3d_reconstruction, evaluation and
auc_evaluation rtol 1e-9 (the same float64 cKDTree and trapezoid
arithmetic); extract_3d_model's files and the AUC CSV equal to the byte;
read_png equal; quality_check's rows: the same keys, steps and
done_reason, each metric within its printed rounding (atol 0.02, the
episodes taking the same actions); render_profile and capacity_probe:
the same keys (the port's stages named for its kernels), the same
binning counts and overflow.
"""
import csv
import json
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings, strategies as st

from fisher_nerf_customized_tpu_torch import cli
from fisher_nerf_customized_tpu_torch.engine.eval import MetricsRecorder
from fisher_nerf_customized_tpu_torch.tools import (
    auc_evaluation, capacity_probe, eval_3d_reconstruction, eval_render,
    evaluation, extract_3d_model, quality_check, render_profile)
from fisher_nerf_customized_tpu_torch.utils.pointcloud import write_ply
from fisher_nerf_customized_tpu_torch.utils.raster import read_png

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_script(name, *args, cwd=None):
    """scripts/<name> in a process of its own (JAX on the CPU): stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / name),
                          *map(str, args)], capture_output=True, text=True,
                         env=env, cwd=cwd or ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def json_of(stdout: str):
    """The JSON document a script printed (before any trailing lines)."""
    return json.JSONDecoder().raw_decode(stdout.strip())[0]


def assert_close(got, ref, rtol, path=""):
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            assert_close(got[k], ref[k], rtol, f"{path}.{k}")
    elif isinstance(ref, float):
        np.testing.assert_allclose(got, ref, rtol=rtol, err_msg=path)
    else:
        assert got == ref, path


@pytest.fixture(scope="module")
def episode_dir(tmp_path_factory):
    """A port episode's output directory (the CLI at 48x48 on the CPU)."""
    tmp = tmp_path_factory.mktemp("tools_ep")
    cli.main(["--scenes_list", "fake_room_0", "--max_steps", "8",
              "--policy", "gaussians_based", "--eval_poses", "4",
              "--img_size", "48", "--device", "cpu", "--log_dir", str(tmp),
              "--name", "cli", "--set", "mapping.num_iters", "4",
              "tpu.capacity", "8192", "policy.planning_queue_size", "5",
              "turn_angle", "30.0", "explore.sample_view_num", "16",
              "explore.cell_size", "0.1", "tpu.pose_chunk", "4"])
    return tmp / "cli" / "fake_room_0"


# -- read_png ----------------------------------------------------------------------

def png_bytes(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of img (H, W) or (H, W, C) with each row's filter
    type given (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int32)
    out, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur, f = rows[y], int(filters[y % len(filters)])
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


def images(draw_channels=(1, 2, 3, 4)):
    return st.tuples(st.integers(1, 24), st.integers(1, 24),
                     st.sampled_from(draw_channels),
                     st.integers(0, 2 ** 32 - 1), st.booleans())


def make_image(h, w, c, seed, flat):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 1 else (h, w, c)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if flat:              # smooth content: the encoders pick other filters
        img = (np.cumsum(img, axis=1) // 17 % 256).astype(np.uint8)
    return img


@settings(max_examples=40, deadline=None)
@given(spec=images(),
       filters=st.lists(st.integers(0, 4), min_size=1, max_size=5))
def test_read_png_undoes_each_filter(spec, filters, tmp_path_factory):
    img = make_image(*spec)
    path = tmp_path_factory.mktemp("png") / "f.png"
    path.write_bytes(png_bytes(img, filters))
    np.testing.assert_array_equal(read_png(str(path)), img)


@settings(max_examples=30, deadline=None)
@given(spec=images((1, 3, 4)))
def test_read_png_matches_cv2(spec, tmp_path_factory):
    """PNGs written by cv2 (its own filter choices): read_png equals
    cv2.imread(IMREAD_UNCHANGED) with the channels in RGB(A) order."""
    img = make_image(*spec)
    path = str(tmp_path_factory.mktemp("cv") / "c.png")
    assert cv2.imwrite(path, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = read_png(path)
    if got.ndim == 3:
        got = got[..., [2, 1, 0, 3][:got.shape[2]]]
    np.testing.assert_array_equal(got, ref)


def test_read_png_reads_write_png(tmp_path):
    from fisher_nerf_customized_tpu_torch.utils.raster import write_png
    img = make_image(9, 13, 3, 5, False)
    write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), img)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        read_png(str(tmp_path / "bad.png"))


# -- the tools against the scripts ---------------------------------------------------

def test_eval_render_matches_script(tmp_path, capsys):
    rng = np.random.default_rng(0)
    rd, gd = tmp_path / "render", tmp_path / "gt"
    rd.mkdir()
    gd.mkdir()
    for i, c in enumerate((3, 3, 1, 4)):
        g = rng.integers(0, 256, (40, 48) + ((c,) if c > 1 else ())
                         ).astype(np.uint8)
        r = np.clip(g.astype(int) + rng.integers(-30, 30, g.shape), 0,
                    255).astype(np.uint8)
        cv2.imwrite(str(gd / f"{i}.png"), g)
        cv2.imwrite(str(rd / f"{i}.png"), r)
    cv2.imwrite(str(rd / "unpaired.png"), g)
    ref = json_of(run_script("eval_render.py", rd, gd))
    got = eval_render.main([str(rd), str(gd), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert got["n"] == ref["n"] == 4
    assert_close(got, ref, 1e-5)


def test_eval_3d_reconstruction_matches_script(tmp_path):
    rng = np.random.default_rng(1)
    gt = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    est = (gt[:2000] + rng.normal(0, 0.03, (2000, 3))).astype(np.float32)
    write_ply(str(tmp_path / "est.ply"), est)
    write_ply(str(tmp_path / "gt.ply"), gt)
    for thresh in ("0.05", "0.02"):
        args = [tmp_path / "est.ply", tmp_path / "gt.ply", "--dist_thresh",
                thresh]
        ref = json_of(run_script("eval_3d_reconstruction.py", *args))
        got = eval_3d_reconstruction.main([*map(str, args), "--device",
                                           "cpu"])
        assert_close(got, ref, 1e-9)


def test_evaluation_matches_script(episode_dir, tmp_path):
    run = tmp_path / "run"
    (run / "pointcloud").mkdir(parents=True)
    pcl = episode_dir / "pointcloud" / "global_pcl_8.ply"
    for t in (3, 8):
        (run / "pointcloud" / f"global_pcl_{t}.ply").write_bytes(
            pcl.read_bytes())
    gt = tmp_path / "gt.ply"
    write_ply(str(gt), np.random.default_rng(2).uniform(
        -3, 3, (5000, 3)).astype(np.float32))
    for extra in (["--fake_scene_seed", "3", "--n_gt_points", "20000"],
                  ["--gt_ply", str(gt), "--dist_thresh", "0.1"]):
        ref = json_of(run_script("evaluation.py", run, *extra))
        got = evaluation.main([str(run), *extra, "--device", "cpu"])
        assert got["step"] == 8 and got["pcl_file"].endswith("_8.ply")
        assert_close(got, ref, 1e-9)
    with pytest.raises(SystemExit):
        evaluation.main([str(tmp_path / "empty"), "--device", "cpu"])


def test_auc_evaluation_matches_script(episode_dir, tmp_path):
    runs = tmp_path / "runs"
    rng = np.random.default_rng(3)
    for policy in ("gaussians_based", "frontier"):
        for k in range(2):
            rec = MetricsRecorder(policy, f"scene{k}")
            for t in range(0, 60, 25):
                rec.record(t, completeness_ratio=float(rng.uniform(0, 50)))
            (runs / f"{policy}{k}").mkdir(parents=True)
            rec.dump(str(runs / f"{policy}{k}" / "recon_metrics.yaml"))
    (runs / "ep").mkdir()
    (runs / "ep" / "recon_metrics.yaml").write_bytes(
        (episode_dir / "recon_metrics.yaml").read_bytes())
    pattern = str(runs / "**" / "recon_metrics.yaml")
    ref_out = run_script("auc_evaluation.py", pattern, "--max_steps", "80",
                         "--csv_out", tmp_path / "ref.csv")
    got = auc_evaluation.main([pattern, "--max_steps", "80", "--csv_out",
                               str(tmp_path / "got.csv")])
    assert_close(got, json_of(ref_out), 1e-9)
    assert (tmp_path / "got.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    with open(tmp_path / "got.csv") as f:
        assert len(list(csv.reader(f))) == 1 + 80 * len(got)


def test_extract_3d_model_matches_script(episode_dir, tmp_path, capsys):
    params = episode_dir / "params8.npz"
    for extra in ([], ["--voxel", "0.1", "--opacity_thresh", "0.5"]):
        ref_out = run_script("extract_3d_model.py", params, "--out_prefix",
                             tmp_path / "ref", *extra)
        extract_3d_model.main([str(params), "--out_prefix",
                               str(tmp_path / "got"), *extra])
        got_out = capsys.readouterr().out
        assert got_out.replace("/got", "/ref") == ref_out
        for suffix in ("_points.ply", "_voxmesh.ply"):
            assert (tmp_path / f"got{suffix}").read_bytes() == \
                (tmp_path / f"ref{suffix}").read_bytes()
    assert "pts)" in got_out and "tris)" in got_out


def test_quality_check_matches_script(tmp_path, monkeypatch):
    """Both at 48x48, 12 steps, on a small config (QUALITY_SET); the JAX
    script's build called with the same image size and its FakeSim on the
    host path (device_obs=False: its device point cloud draws from
    jax.random, which the port cannot reproduce, ROADMAP.md hazard f)."""
    qs = ("tpu.capacity=8192,mapping.num_iters=4,"
          "explore.sample_view_num=16,tpu.pose_chunk=4")
    driver = tmp_path / "ref.py"
    driver.write_text(
        "import functools, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
        "import fisher_nerf_customized_tpu.envs.fake_sim as fs\n"
        "init = fs.FakeSim.__init__\n"
        "fs.FakeSim.__init__ = lambda self, *a, **kw: init(\n"
        "    self, *a, **dict(kw, device_obs=False))\n"
        "import quality_check as q\n"
        f"q.build = functools.partial(q.build, img=48, "
        f"workdir={str(tmp_path / 'ref')!r})\n"
        "print(json.dumps(q.run_policy('gaussians_based', 12)))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", QUALITY_SET=qs)
    out = subprocess.run([sys.executable, str(driver)], capture_output=True,
                         text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    monkeypatch.setenv("QUALITY_SET", qs)
    got = quality_check.run_policy("gaussians_based", 12, device="cpu",
                                   img=48, workdir=str(tmp_path / "got"))
    assert list(got) == list(ref)
    assert (got["policy"], got["steps"], got["done"]) == \
        (ref["policy"], ref["steps"], ref["done"])
    for k in ("completeness", "acc_m", "fpr", "cov2d", "psnr", "auc"):
        np.testing.assert_allclose(got[k], ref[k], atol=0.02, err_msg=k)
    # the eight longest timer phases (which eight depends on the clock)
    assert len(got["phase_totals_s"]) == len(ref["phase_totals_s"]) == 8


def test_render_profile_matches_script(capsys):
    args = ["--n", "2000", "--img", "64", "--reps", "1"]
    ref = json.loads(run_script("render_profile.py", *args))
    got = render_profile.main(args + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(got))
    assert list(got) == list(ref)
    names = dict(pallas_blend_ms="blend_ms",
                 full_render_pallas_ms="full_render_ms",
                 full_render_xla_ms="full_render_plain_ms")
    for n, row in ref["stages"].items():
        port = got["stages"][int(n)]
        assert list(port) == [names.get(k, k) for k in row]
        assert port["overflow"] == row["overflow"]
        assert port["mean_count"] == row["mean_count"]
        assert all(v > 0 for k, v in port.items() if k.endswith("_ms"))


def test_capacity_probe_matches_script():
    args = ["--n", "3000", "--tiers", "64,128", "--reps", "1"]
    ref = json.loads(run_script("capacity_probe.py", *args))
    got = capacity_probe.main(args + ["--device", "cpu"])
    assert list(got) == list(ref)
    assert (got["n_gaussians"], got["capacity"]) == \
        (ref["n_gaussians"], ref["capacity"])
    for g, r in zip(got["tiers"], ref["tiers"]):
        assert list(g) == list(r)
        assert g["max_per_tile"] == r["max_per_tile"]
        assert g["overflow_frac"] == r["overflow_frac"]
        assert all(g[k] > 0 for k in ("render_ms", "loss_grad_ms",
                                      "pose_eval_ms_per_pose"))


# -- the scripts that import neither package, on the port's output -------------------

def test_print_results_reads_the_port_episode(episode_dir, tmp_path):
    out = run_script("print_results.py", episode_dir.parent, "--csv",
                     tmp_path / "r.csv")
    assert "fake_room_0" in out
    with open(tmp_path / "r.csv") as f:
        rows = list(csv.DictReader(f))
    res = json.loads((episode_dir / "result.json").read_text())
    row = next(r for r in rows if r["scene"] == "fake_room_0")
    assert int(row["steps"]) == res["steps"] == 8
    np.testing.assert_allclose(float(row["psnr"]), res["eval"]["psnr"],
                               rtol=1e-6)
    np.testing.assert_allclose(float(row["completeness"]),
                               res["recon"]["completeness_ratio"], rtol=1e-6)


def test_compare_curves_reads_the_port_episode(episode_dir, tmp_path):
    ref_dir = tmp_path / "reference"
    ref_dir.mkdir()
    with open(episode_dir / "recon_metrics.yaml") as f:
        curve = yaml.safe_load(f)
    (ref_dir / "FisherRF.yaml").write_text(yaml.safe_dump(dict(
        experiment=dict(policy_name="FisherRF"), steps=curve["steps"])))
    run_script("compare_curves.py", "--ours", episode_dir, "--reference",
               ref_dir, "--out", tmp_path / "c.csv")
    with open(tmp_path / "c.csv") as f:
        rows = list(csv.DictReader(f))
    assert any("gaussians_based" in json.dumps(r) for r in rows)
