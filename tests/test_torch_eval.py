"""The port's engine/eval.py against the JAX package's on the same numpy
inputs, made from seeds.

Tolerances: lpips_proxy, render_metrics and _batch_render_metrics rtol
1e-5 (both sum the conv and filter products in f32, in different
orders); uniform_eval_poses, the MetricsRecorder YAML and the PSNR
scatter image equal; the reconstruction metrics rtol 1e-9 (both run
scipy's cKDTree in float64; the running form against the one-shot one
is exact up to the order of its sums).  _nn_dists' card path (the 1-NN
kernel's rows, the distance recomputed in float64) is held to cKDTree at
rtol 1e-12 on the rows of the kernel's CPU twin."""
import cv2
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial import cKDTree

from fisher_nerf_customized_tpu.engine import eval as jeval
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene as JScene
from fisher_nerf_customized_tpu_torch.engine import eval as teval
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene as TScene
from fisher_nerf_customized_tpu_torch.ops import knn as tknn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def image_pairs(seed, p=3, h=32, w=40):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-0.1, 1.1, (p, h, w, 3)).astype(np.float32)
    g = np.clip(r + rng.normal(0, 0.1, r.shape), -0.05, 1.05).astype(
        np.float32)
    d = rng.uniform(0.1, 5, (p, h, w)).astype(np.float32)
    gd = rng.uniform(0, 5, (p, h, w)).astype(np.float32)
    gd[0, :8] = 0.0                          # invalid-depth masking
    gd[-1] = 0.0                             # a pose with no valid depth
    return r, g, d, gd


@pytest.mark.parametrize("seed", [0, 1])
def test_lpips_proxy(seed):
    r, g, _d, _gd = image_pairs(seed)
    for i in range(len(r)):
        ref = float(jeval.lpips_proxy(r[i], g[i]))
        got = float(teval.lpips_proxy(torch.from_numpy(r[i]),
                                      torch.from_numpy(g[i])))
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_render_metrics():
    r, g, d, gd = image_pairs(2)
    for i in range(len(r)):
        ref = jeval.render_metrics(r[i], g[i], d[i], gd[i])
        got = teval.render_metrics(torch.from_numpy(r[i]), g[i],
                                   torch.from_numpy(d[i]), gd[i])
        assert got.keys() == ref.keys()
        for k in ref:
            if np.isnan(ref[k]):
                assert np.isnan(got[k]), k
            else:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           err_msg=k)


def test_batch_render_metrics():
    r, g, d, gd = image_pairs(3, p=4)
    ref = jeval._batch_render_metrics(r, g, d, gd)
    got = teval._batch_render_metrics(*map(torch.from_numpy, (r, g, d, gd)))
    for name, a, b in zip(("psnr", "ssim", "lpips", "mae"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   err_msg=name)


def test_uniform_eval_poses():
    for kind in ("default", "multi_room"):
        js, ts = getattr(JScene, kind)(seed=5), getattr(TScene, kind)(seed=5)
        np.testing.assert_array_equal(
            teval.uniform_eval_poses(ts, 40, 1.25),
            jeval.uniform_eval_poses(js, 40, 1.25))


def recon_case(seed):
    scene = JScene.multi_room(seed=seed)
    gt = scene.sample_surface_points(6000, rng=np.random.default_rng(seed))
    rng = np.random.default_rng(100 + seed)
    parts = [scene.sample_surface_points(n, rng=np.random.default_rng(n))
             + rng.normal(0, 0.03, (n, 3)).astype(np.float32)
             for n in (700, 0, 1300, 500)]
    return scene, gt, parts


@pytest.mark.parametrize("surface", [False, True])
def test_reconstruction_metrics(surface):
    jscene, gt, parts = recon_case(7)
    tscene = TScene.multi_room(seed=7)
    jfn = jscene.surface_distance if surface else None
    tfn = tscene.surface_distance if surface else None
    est = np.concatenate(parts)
    ref = jeval.accuracy_comp_ratio_from_pcl(est, gt, 0.05, jfn)
    got = teval.accuracy_comp_ratio_from_pcl(est, gt, 0.05, tfn)
    jinc = jeval.IncrementalReconMetric(gt, 0.05, surface_dist_fn=jfn)
    tinc = teval.IncrementalReconMetric(gt, 0.05, surface_dist_fn=tfn)
    for part in parts:
        jrow, trow = jinc.update(part), tinc.update(part)
        for k in jrow:
            np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-9,
                                       err_msg=k)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, err_msg=k)
        np.testing.assert_allclose(trow[k], got[k], rtol=1e-9, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_nn_dists_recompute_on_the_twins_rows(seed):
    """On the card, _nn_dists takes each query's nearest ref from the 1-NN
    kernel and recomputes its distance in float64 (_dists_to).  Fed the
    rows of the kernel's CPU twin, it gives cKDTree's distances at rtol
    1e-12 wherever the rows are cKDTree's, and a near tie elsewhere."""
    _scene, gt, parts = recon_case(seed)
    est = np.concatenate(parts)
    for q, r in ((gt, est), (est, gt)):
        _d, idx = tknn.knn(torch.from_numpy(q), torch.from_numpy(r), k=1)
        idx = idx[:, 0].numpy()
        ref_d, ref_i = cKDTree(r).query(q, k=1)
        same = idx == ref_i
        got = teval._dists_to(q, r, idx)
        assert got.dtype == np.float64 and same.mean() > 0.999
        np.testing.assert_allclose(got[same], ref_d[same], rtol=1e-12)
        np.testing.assert_allclose(got[~same], ref_d[~same], rtol=0,
                                   atol=1e-6)


def test_nn_dists_on_the_cpu_is_ckdtree():
    _scene, gt, parts = recon_case(3)
    est = np.concatenate(parts)
    ref, _i = cKDTree(est).query(gt, k=1)
    np.testing.assert_array_equal(teval._nn_dists(gt, est, device="cpu"), ref)
    a = teval.IncrementalReconMetric(gt, 0.05, device="cpu")
    b = teval.IncrementalReconMetric(gt, 0.05)
    for part in parts:
        assert a.update(part) == b.update(part)
    assert a.gt_dev is None


def test_recon_state_dict_round_trip():
    _scene, gt, parts = recon_case(8)
    a = teval.IncrementalReconMetric(gt, 0.05)
    a.update(parts[0])
    state = a.state_dict()
    assert state["d_gt_min"].dtype == np.float64
    b = teval.IncrementalReconMetric(gt, 0.05)
    assert b.load_state_dict(state)
    for part in parts[1:]:
        ra, rb = a.update(part), b.update(part)
    assert ra == rb
    # the JAX package's state (d_gt_min in float32) loads too
    j = jeval.IncrementalReconMetric(gt, 0.05)
    j.update(parts[0])
    c = teval.IncrementalReconMetric(gt, 0.05)
    assert c.load_state_dict(j.state_dict())
    assert c.n_est == len(parts[0])
    assert not c.load_state_dict(dict(d_gt_min=np.zeros(3),
                                      acc=np.zeros(3)))


def test_trapezoid_auc_and_recorder(tmp_path):
    rng = np.random.default_rng(9)
    for n in (0, 1, 2, 7):
        v = rng.uniform(0, 100, n).tolist()
        for max_steps in (None, 10):
            assert teval.trapezoid_auc(v, max_steps) == \
                jeval.trapezoid_auc(v, max_steps)
    recs = []
    for mod in (jeval, teval):
        rec = mod.MetricsRecorder("gaussians_based", "fake_room_0")
        for t in (0, 25, 50):
            rec.record(t, completeness_ratio=t * 0.7, acc_distance=0.01 * t,
                       fpr=np.float32(1.5))
        rec.record(60, eval_psnr=21.5)
        recs.append(rec)
    paths = [tmp_path / "jax.yaml", tmp_path / "torch.yaml"]
    for rec, path in zip(recs, paths):
        rec.dump(str(path))
    assert paths[0].read_text() == paths[1].read_text()
    back = teval.MetricsRecorder("x", "y")
    back.load(str(paths[1]))
    assert back.header == recs[1].header and back.steps == recs[1].steps
    assert back.auc() == recs[1].auc() == yaml.safe_load(
        paths[0].read_text())["auc"]


def test_evaluate_ate():
    rng = np.random.default_rng(11)
    gt = np.tile(np.eye(4), (30, 1, 1))
    gt[:, :3, 3] = rng.uniform(-3, 3, (30, 3))
    est = gt.copy()
    a = 0.3
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
    est[:, :3, 3] = gt[:, :3, 3] @ rot.T + [0.5, -0.2, 1.0] \
        + rng.normal(0, 0.02, (30, 3))
    assert teval.evaluate_ate(gt, est) == jeval.evaluate_ate(gt, est)
    assert teval.evaluate_ate(gt, est) < 0.05


def test_psnr_scatter_png(tmp_path):
    """The PNG (written with zlib) decodes to the JAX package's cv2 image,
    pixel for pixel, and the plasma table is cv2.applyColorMap's."""
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8).reshape(-1, 1),
                            cv2.COLORMAP_PLASMA)[:, 0, ::-1]
    np.testing.assert_array_equal(teval._PLASMA_RGB, lut)
    jscene, tscene = JScene.multi_room(seed=2), TScene.multi_room(seed=2)
    poses = teval.uniform_eval_poses(tscene, 300, 1.25)
    psnrs = np.random.default_rng(0).uniform(12, 30, len(poses))
    jpath, tpath = tmp_path / "j.png", tmp_path / "t.png"
    jeval.save_psnr_scatter(str(jpath), jscene, poses, psnrs)
    teval.save_psnr_scatter(str(tpath), tscene, poses, psnrs)
    ref = cv2.imread(str(jpath), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tpath), cv2.IMREAD_UNCHANGED)
    assert got.shape == ref.shape == (256, 256, 3)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 50


def test_lpips_weights_are_not_ported():
    """LPIPS(alex) is ported (tests/test_torch_perceptual.py holds it to
    the JAX package's); what stays refused is a checkpoint that is not
    there.  None turns the metric off."""
    teval.set_lpips_weights(None)
    with pytest.raises(FileNotFoundError):
        teval.set_lpips_weights("alex.pth")
    assert teval._LPIPS_NET is None


def test_eval_pose_curve():
    """EvalPoseCurve on stub sims and maps that hand both packages the
    same seeded images: the same three numbers."""
    import jax.numpy as jnp

    def image(c2w, salt):
        rng = np.random.default_rng(int(abs(c2w[0, 3]) * 1e4) + salt)
        depth = rng.uniform(0.0, 4.0, (16, 20)).astype(np.float32)
        depth[:3] = 0.0
        return rng.uniform(0, 1, (16, 20, 3)).astype(np.float32), depth

    class Sim:
        def render_at(self, c2w):
            return image(c2w, 0)

    class Map:
        def __init__(self, to):
            self.to = to

        def render_at_pose(self, c2w):
            rgb, depth = image(c2w, 1)
            return dict(render=self.to(rgb), depth=self.to(depth))

    ref = jeval.EvalPoseCurve(JScene.multi_room(seed=1), Sim()).update(
        Map(jnp.asarray))
    got = teval.EvalPoseCurve(TScene.multi_room(seed=1), Sim()).update(
        Map(torch.from_numpy))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
