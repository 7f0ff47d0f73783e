"""The rest of SLAM's settings, JAX package against the PyTorch port on
the CPU: gradient clone/split densification (`gs_densify`, with the JAX
package's draws fed through `GaussianSLAM.densify_draw`), Adam's slot
reset, the invisible-Gaussian prune (`_seen_from_poses`,
`prune_invisible`, `delete_gaussians_by_index`) and an episode with
`explore.prune_invisible`.

Tolerances: gs_densify's parameters rtol 1e-6 with atol 1e-6 of the
field's largest value (the same f32 arithmetic, but the children's
offsets R (noise * s) are summed in another order, which moves a mean
by an ulp of the parent's: relative to a child's mean near 0, more);
n_active, the visibility masks and the removed counts exact; the
mapping losses of a densifying run rtol 1e-4 (tests/test_torch_mapping.py's
reason).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.config import get_cfg_defaults as jcfg
from fisher_nerf_customized_tpu.engine import driver as jdriver
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene as JScene
from fisher_nerf_customized_tpu.envs.fake_sim import FakeSim as JSim
from fisher_nerf_customized_tpu.models import gaussian_state as jgs
from fisher_nerf_customized_tpu.models import slam as jslam
from fisher_nerf_customized_tpu.ops.camera import Camera as JCamera
from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults as tcfg
from fisher_nerf_customized_tpu_torch.engine import driver as tdriver
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene as TScene
from fisher_nerf_customized_tpu_torch.envs.fake_sim import FakeSim as TSim
from fisher_nerf_customized_tpu_torch.models import gaussian_state as tgs
from fisher_nerf_customized_tpu_torch.models import slam as tslam
from fisher_nerf_customized_tpu_torch.ops.camera import Camera as TCamera

from test_engine import IMG as EP_IMG
from test_engine import episode_cfg
from test_torch_mapping import ACTIONS, make_cfg
from test_torch_tracking import frames_of

STATE_KEYS = tgs.PARAM_KEYS + ("timestep",)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_densify_draw(time_idx, n_children, shape):
    """The JAX package's gs_densify draws at time_idx: PRNGKey(time_idx),
    then per child a split and a standard normal of `shape`."""
    key = jax.random.PRNGKey(int(time_idx))
    out = []
    for _ in range(n_children):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return torch.from_numpy(np.stack(out))


def both_states(d):
    """The same numpy state as a JAX and a port GaussianState."""
    js = jgs.GaussianState(**{k: jnp.asarray(d[k]) for k in STATE_KEYS},
                           n_active=jnp.asarray(d["n_active"], jnp.int32))
    ts = tgs.GaussianState(**{k: torch.from_numpy(d[k]) for k in STATE_KEYS},
                           n_active=torch.tensor(d["n_active"],
                                                 dtype=torch.int32))
    return js, ts


def assert_states_equal(ts, js, rtol=0.0):
    """Equal n_active, and the live rows equal within rtol with atol rtol
    of each field's largest value (to the bit for rtol 0)."""
    n = int(js.n_active)
    assert int(ts.n_active) == n
    for k in STATE_KEYS:
        ref = np.asarray(getattr(js, k))[:n]
        np.testing.assert_allclose(getattr(ts, k).numpy()[:n], ref,
                                   rtol=rtol, atol=rtol * np.abs(ref).max(),
                                   err_msg=k)


@pytest.mark.parametrize("n_children", [2, 3])
def test_gs_densify_matches_jax(n_children):
    rng = np.random.default_rng(n_children)
    cap, n = 256, 120
    d = dict(
        means3D=rng.normal(size=(cap, 3)).astype(np.float32),
        rgb_colors=rng.uniform(size=(cap, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(cap, 4)).astype(np.float32),
        logit_opacities=rng.normal(0, 4, size=(cap, 1)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.005, 0.12, size=(cap, 1))
                          * rng.uniform(0.8, 1.0, size=(cap, 3))).astype(
                              np.float32),
        timestep=rng.integers(0, 9, cap).astype(np.float32),
        n_active=n)
    ga = rng.uniform(0, 2e-3, cap).astype(np.float32)
    dn = rng.integers(0, 4, cap).astype(np.float32)
    js, ts = both_states(d)
    kw = dict(grad_thresh=2e-4, split_scale=0.05,
              num_to_split_into=n_children, removal_opacity_threshold=0.005,
              time_idx=7.0)
    ref = jgs.gs_densify(js, jnp.asarray(ga), jnp.asarray(dn),
                         jax.random.PRNGKey(7), **kw)
    got = tgs.gs_densify(ts, torch.from_numpy(ga), torch.from_numpy(dn),
                         jax_densify_draw(7, n_children, (cap, 3)), **kw)
    # clones, children and removals all happen
    grads = np.where(dn > 0, ga / np.maximum(dn, 1), 0)
    high = (np.arange(cap) < n) & (grads >= 2e-4)
    big = np.exp(d["log_scales"]).max(1) > 0.05
    assert (high & big).sum() > 0 and (high & ~big).sum() > 0
    assert int(ref.n_active) != n
    assert_states_equal(got, ref, rtol=1e-6)


def test_adam_reset_slots_matches_jax():
    rng = np.random.default_rng(5)
    params = {k: rng.normal(size=(40, w)).astype(np.float32)
              for k, w in zip(tgs.PARAM_KEYS, (3, 3, 4, 1, 3))}
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
    lrs = {k: 1e-3 for k in params}
    jo = jgs.adam_init({k: jnp.asarray(v) for k, v in params.items()})
    to = tgs.adam_init({k: torch.from_numpy(v) for k, v in params.items()})
    _p, jo = jgs.adam_step(jo, {k: jnp.asarray(v) for k, v in params.items()},
                           {k: jnp.asarray(v) for k, v in grads.items()}, lrs)
    _p, to = tgs.adam_step(to, {k: torch.from_numpy(v) for k, v in
                                params.items()},
                           {k: torch.from_numpy(v) for k, v in grads.items()},
                           lrs)
    dest = np.array([3, 7, 40, 12, 40], np.int32)     # 40: past the end
    jr = jgs.adam_reset_slots(jo, jnp.asarray(dest))
    tr = tgs.adam_reset_slots(to, torch.from_numpy(dest))
    for k in tgs.PARAM_KEYS:
        for got, ref in ((tr.mu[k], jr.mu[k]), (tr.nu[k], jr.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-12)
            assert not got.numpy()[[3, 7, 12]].any()
            assert got.numpy()[[0, 39]].all()
    assert tr.count == int(jr.count) == 1


def densify_cfg(get_defaults, workdir):
    cfg = make_cfg(get_defaults, workdir)
    cfg.mapping.use_gaussian_splatting_densification = True
    # a threshold that this small run's gradients reach
    cfg.mapping.densify_dict.grad_thresh = 1e-4
    cfg.mapping.densify_dict.removal_opacity_threshold = 0.05
    return cfg


def test_densifying_track_rgbd_matches_jax(tmp_path, monkeypatch):
    """track_rgbd with use_gaussian_splatting_densification in both
    packages, the port fed the JAX draws: the same n_active after each
    event, and each event's clone/split counts."""
    frames = frames_of(ACTIONS)
    js = jslam.GaussianSLAM(densify_cfg(jcfg, tmp_path / "jax"))
    ts = tslam.GaussianSLAM(densify_cfg(tcfg, tmp_path / "port"),
                            device="cpu")
    ts.densify_draw = jax_densify_draw
    sizes = dict(jax=[], port=[])

    def recording(fn, name):
        def wrapped(state, *args, **kw):
            out = fn(state, *args, **kw)
            sizes[name].append((int(state.n_active), int(out.n_active)))
            return out
        return wrapped

    # the JAX package imports gs_densify at the call, the port at import
    monkeypatch.setattr(jgs, "gs_densify", recording(jgs.gs_densify, "jax"))
    monkeypatch.setattr(tslam, "gs_densify",
                        recording(tgs.gs_densify, "port"))
    events = dict(jax=[], port=[])
    for color, depth, w2c in frames:
        for name, slam in (("jax", js), ("port", ts)):
            before = slam.last_losses
            slam.track_rgbd(color, depth, gt_w2c=w2c)
            if slam.last_losses is not before:
                events[name].append((np.asarray(slam.last_losses),
                                     slam.n_active))
    assert len(sizes["port"]) == len(sizes["jax"]) == 2
    assert sizes["port"] == sizes["jax"]
    assert any(before != after for before, after in sizes["port"])
    for (got_l, got_n), (ref_l, ref_n) in zip(events["port"], events["jax"]):
        np.testing.assert_allclose(got_l, ref_l, rtol=1e-4)
        assert got_n == ref_n


def test_densify_grows_the_capacity(tmp_path):
    """A clone/split that outgrows the capacity grows it first, and the
    mapping statistics are padded to it (the JAX package's mapping event
    fails there on the two lengths).  Every slot's gradient passes the
    threshold, so the first event's clones and children overflow 512."""
    cfg = densify_cfg(tcfg, tmp_path)
    cfg.tpu.capacity = 512
    cfg.mapping.densify_dict.grad_thresh = 0.0
    ts = tslam.GaussianSLAM(cfg, device="cpu")
    ts.densify_draw = jax_densify_draw
    sizes = []
    for color, depth, w2c in frames_of(ACTIONS[:1]):
        ts.track_rgbd(color, depth, gt_w2c=w2c)
        sizes.append((ts.n_active, ts.state.capacity))
    (n0, cap0), (n1, cap1) = sizes
    assert cap0 == 512 and cap1 > cap0 and n1 > n0
    for k in STATE_KEYS:
        assert bool(torch.isfinite(getattr(ts.state, k)[:n1]).all()), k


@pytest.fixture(scope="module")
def pruned_map(tmp_path_factory):
    """The mapping test's map in the JAX package, the port's copy of it,
    and poses: the keyframes' and some facing away from the map."""
    tmp = tmp_path_factory.mktemp("prune")
    frames = frames_of(ACTIONS)
    js = jslam.GaussianSLAM(make_cfg(jcfg, tmp / "jax"))
    for color, depth, w2c in frames:
        js.track_rgbd(color, depth, gt_w2c=w2c)
    state = {k: np.asarray(getattr(js.state, k))
             for k in STATE_KEYS + ("n_active",)}
    return dict(js=js, state=state, tmp=tmp)


def keyframes_of(pruned_map, n_kf):
    kf = pruned_map["js"].keyframes.state_dict()
    return {k: v[:n_kf] for k, v in kf.items()}


def port_copy(pruned_map, n_kf=None):
    """The map in the port, with its first n_kf keyframes (all for
    None)."""
    js = pruned_map["js"]
    ts = tslam.GaussianSLAM(make_cfg(tcfg, pruned_map["tmp"] / "port"),
                            device="cpu")
    ts.state = tgs.state_from_numpy(pruned_map["state"], js.state.capacity,
                                    device="cpu")
    ts.keyframes.load_state_dict(keyframes_of(pruned_map, n_kf))
    ts.initialized = True
    return ts


def jax_copy(pruned_map, n_kf=None):
    js = jslam.GaussianSLAM(make_cfg(jcfg, pruned_map["tmp"] / "jax2"))
    d = pruned_map["state"]
    js.state = jgs.GaussianState(
        **{k: jnp.asarray(d[k]) for k in STATE_KEYS},
        n_active=jnp.asarray(d["n_active"], jnp.int32))
    js.keyframes.load_state_dict(keyframes_of(pruned_map, n_kf))
    js.initialized = True
    return js


def turned(w2c, yaw):
    out = w2c.copy()
    c, s = np.cos(yaw), np.sin(yaw)
    out[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                           np.float32) @ w2c[:3, :3]
    return out


@pytest.mark.parametrize("which", ["keyframes", "one_turned", "padded"])
def test_seen_from_poses_matches_jax(pruned_map, which):
    js = pruned_map["js"]
    ts = port_copy(pruned_map)
    kf = js.keyframes.stacked_w2cs()
    if which == "keyframes":
        w2cs, n = kf, len(kf)
    elif which == "one_turned":
        w2cs, n = turned(kf[:1], 2.5)[None][0], 1
    else:
        # 2 real poses and 3 rows of padding that see everything
        w2cs = np.concatenate([turned(kf[:1], 2.5)[None][0],
                               turned(kf[1:2], 2.0)[None][0],
                               np.repeat(kf[:1], 3, axis=0)])
        n = 2
    ref = np.asarray(jslam._seen_from_poses(js.state, jnp.asarray(w2cs), n,
                                            js.camera))
    got = tslam._seen_from_poses(ts.state, torch.from_numpy(w2cs), n,
                                 ts.camera).numpy()
    np.testing.assert_array_equal(got, ref)
    n_act = js.n_active
    assert 0 < ref[:n_act].sum() <= n_act
    if which != "keyframes":
        assert ref[:n_act].sum() < n_act
        assert not ref[n_act:].any()


def test_prune_invisible_matches_jax(pruned_map):
    """prune_invisible over the first keyframe (the Gaussians the later
    frames added outside its view go): the same removals and state as the
    JAX package, and the cached H_train, permuted with the state, equal
    to a recompute (a Gaussian that no keyframe sees enters none of their
    renders, so the other rows keep their values)."""
    js, ts = jax_copy(pruned_map, 1), port_copy(pruned_map, 1)
    ts.compute_H_train()
    ref = js.prune_invisible()
    got = ts.prune_invisible()
    assert got == ref > 0
    assert_states_equal(ts.state, js.state)
    cached = ts._h_train_cache
    assert cached[0] == ts._h_train_key()
    ts._h_train_cache = None
    torch.testing.assert_close(cached[1], ts.compute_H_train(), rtol=1e-5,
                               atol=0.0)
    # nothing more to remove: the state and the cache stay
    state, key = ts.state, ts._h_train_key()
    assert ts.prune_invisible() == js.prune_invisible() == 0
    assert ts.state is state and ts._h_train_key() == key
    # from given poses: two turned away from the map and a keyframe
    kf = pruned_map["js"].keyframes.stacked_w2cs()
    poses = [turned(kf[0], 2.5), turned(kf[1], 2.0), kf[2]]
    js, ts = jax_copy(pruned_map), port_copy(pruned_map)
    assert ts.prune_invisible(poses) == js.prune_invisible(poses) > 0
    assert_states_equal(ts.state, js.state)


def test_delete_gaussians_by_index_matches_jax(pruned_map):
    js, ts = jax_copy(pruned_map), port_copy(pruned_map)
    idx = np.random.default_rng(0).choice(js.n_active, 40, replace=False)
    js.delete_gaussians_by_index(idx)
    ts.delete_gaussians_by_index(idx)
    assert ts.n_active == js.n_active == int(pruned_map["state"]["n_active"]) \
        - 40
    assert_states_equal(ts.state, js.state)


def run_pruning_episode(pkg, tmp_path, monkeypatch, steps=20):
    """A gaussians_based episode with explore.prune_invisible: the counts
    prune_invisible removed, in call order, and the actions."""
    cfg = episode_cfg(tmp_path / pkg, steps=steps)
    cfg.explore.prune_invisible = True
    # keyframes at 0, 11 and 18 only: the mapping event at 5 adds
    # Gaussians that the keyframes may not see
    cfg.keyframe_every = 12
    if pkg == "jax":
        cam_t, scene_t, sim_t, drv, slam_cls = (JCamera, JScene, JSim,
                                                jdriver, jslam.GaussianSLAM)
        kw, sim_kw = {}, dict(device_obs=False)
    else:
        port = tcfg()
        port.merge_from_other(cfg.to_dict())
        cfg = port
        cam_t, scene_t, sim_t, drv, slam_cls = (TCamera, TScene, TSim,
                                                tdriver, tslam.GaussianSLAM)
        kw = sim_kw = dict(device="cpu")
    cam = cam_t(fx=float(EP_IMG), fy=float(EP_IMG), cx=EP_IMG / 2,
                cy=EP_IMG / 2, width=EP_IMG, height=EP_IMG)
    scene = scene_t(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                    obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = sim_t(scene, cam, forward_step=0.15, turn_angle=30.0, seed=3,
                **sim_kw)
    removed, actions = [], []
    fn = slam_cls.prune_invisible

    def recording(self, *a, **k):
        removed.append(fn(self, *a, **k))
        return removed[-1]

    monkeypatch.setattr(slam_cls, "prune_invisible", recording)
    step = sim.step

    def stepping(a):
        actions.append(int(a))
        return step(a)

    sim.step = stepping
    mapper = drv.ActiveMapper(cfg, sim, scene=scene, seed=0, **kw)
    result = mapper.test_navigation(n_eval_poses=0)
    return removed, actions, result


def test_prune_invisible_episode_matches_jax(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        j_removed, j_actions, j_res = run_pruning_episode("jax", tmp_path, mp)
    with pytest.MonkeyPatch.context() as mp:
        t_removed, t_actions, t_res = run_pruning_episode("torch", tmp_path,
                                                          mp)
    assert t_res["steps"] == j_res["steps"] == 20
    assert len(t_removed) == t_res["planning_events"] >= 2
    assert t_removed == j_removed and sum(t_removed) > 0
    assert t_actions == j_actions
    assert t_res["n_gaussians"] == j_res["n_gaussians"]
