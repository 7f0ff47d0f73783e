"""The DD-PPO pointgoal network (planning/ddppo_net.py) and the local
policies (planning/local_policy.py), the JAX package against the PyTorch
port on the CPU.

The JAX package's `init_params` at hidden size 64 and 64x64 depth load
by name into the port's module (its state_dict keys are the JAX
package's flat names), and the port's own `init_params` draws the same
numbers.  Over 3 steps of one episode (the mask 0 at step 0, the hidden
state and the previous action carried) the logits, the value and the
hidden state equal the JAX forward's within 1e-4 (absolute, on values
of order 1: conv, GroupNorm and LSTM sums in another order), and the
deterministic actions are equal.  A state_dict saved in the habitat
checkpoint format loads through load_torch_checkpoint; without a
checkpoint DdppoPolicy takes the geometric follower's action, which,
like PathFollower.rollout, equals the JAX package's.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.planning import ddppo_net as jnet
from fisher_nerf_customized_tpu.planning import local_policy as jpol
from fisher_nerf_customized_tpu_torch.planning import ddppo_net as tnet
from fisher_nerf_customized_tpu_torch.planning import local_policy as tpol

HID = 64
HW = 64
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jnet.init_params(3, hidden_size=HID, input_hw=HW)


def test_state_dict_names_and_init_match_jax(params):
    net = tnet.DdppoNet(HID, HW)
    sd = net.state_dict()
    assert set(sd) == set(params)
    for name, shp in tnet.param_shapes(HID, HW).items():
        assert tuple(sd[name].shape) == shp == tuple(params[name].shape)
    assert tnet.param_shapes() == jnet.param_shapes()
    for hw in (64, 128, 256, 480):
        assert tnet.compression_channels(hw) == jnet.compression_channels(hw)
    own = tnet.init_params(3, hidden_size=HID, input_hw=HW)
    for name, val in own.items():
        np.testing.assert_array_equal(val, np.asarray(params[name]),
                                      err_msg=name)


def test_forward_matches_jax_over_an_episode(params):
    net = tnet.from_params(params, HID, HW, device="cpu")
    rng = np.random.default_rng(1)
    j_hidden = jnet.zero_state(HID)
    t_hidden = tnet.zero_state(HID, device="cpu")
    # a non-zero state before step 0: the mask must clear it
    noise = rng.normal(0, 0.3, j_hidden.shape).astype(np.float32)
    j_hidden, t_hidden = jnp.asarray(noise), torch.from_numpy(noise)
    j_prev = jnp.zeros((1,), jnp.int32)
    t_prev = torch.zeros((1,), dtype=torch.int32)
    for step in range(3):
        depth = rng.uniform(0, 1, (1, HW, HW, 1)).astype(np.float32)
        goal = np.asarray([[2.0 - 0.5 * step, 0.4 * step - 0.3]], np.float32)
        mask = np.asarray([0.0 if step == 0 else 1.0], np.float32)
        jl, jv, j_hidden = jnet.forward(params, jnp.asarray(depth),
                                        jnp.asarray(goal), j_hidden, j_prev,
                                        jnp.asarray(mask))
        tl, tv, t_hidden = net(torch.from_numpy(depth),
                               torch.from_numpy(goal), t_hidden, t_prev,
                               torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
        np.testing.assert_allclose(t_hidden.numpy(), np.asarray(j_hidden),
                                   atol=ATOL)
        ja, _v, _h = jnet.act(params, jnp.asarray(depth), jnp.asarray(goal),
                              j_hidden, j_prev, jnp.asarray(mask), None,
                              deterministic=True)
        ta, _v, _h = tnet.act(net, torch.from_numpy(depth),
                              torch.from_numpy(goal), t_hidden, t_prev,
                              torch.from_numpy(mask), deterministic=True)
        assert ta.dtype == torch.int32
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        j_prev, t_prev = ja, ta
    assert float(np.abs(np.asarray(jl)).max()) > 1e-3


def test_sampled_act_follows_its_generator(params):
    net = tnet.from_params(params, HID, HW, device="cpu")
    depth = torch.rand(2, HW, HW, 1, generator=torch.Generator().manual_seed(0))
    args = (depth, torch.tensor([[1.0, 0.2], [3.0, -1.0]]),
            tnet.zero_state(HID, batch=2, device="cpu"),
            torch.tensor([1, 3], dtype=torch.int32), torch.ones(2))
    draws = [tnet.act(net, *args, generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0][0], draws[1][0])
    assert all(0 <= int(a) < 4 for a in draws[0][0])


def test_checkpoint_loads_by_name(params, tmp_path):
    net = tnet.from_params(params, HID, HW, device="cpu")
    sd = {"actor_critic." + k: v for k, v in net.state_dict().items()}
    sd["actor_critic.net.extra_buffer"] = torch.zeros(3)   # ignored
    path = str(tmp_path / "ckpt.11.pth")
    torch.save({"state_dict": sd,
                "model_args": SimpleNamespace(hidden_size=HID)}, path)
    loaded, hid = tnet.load_torch_checkpoint(path, input_hw=HW, device="cpu")
    assert hid == HID
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    j_params, j_hid = jnet.load_torch_checkpoint(path, input_hw=HW)
    assert j_hid == HID and set(j_params) == set(net.state_dict())
    del sd["actor_critic.critic.fc.bias"]
    torch.save({"state_dict": sd,
                "model_args": SimpleNamespace(hidden_size=HID)}, path)
    with pytest.raises(KeyError):
        tnet.load_torch_checkpoint(path, input_hw=HW, device="cpu")
    torch.save({"state_dict": sd}, path)        # hidden size 512 assumed
    with pytest.raises(ValueError):
        tnet.load_torch_checkpoint(path, input_hw=HW, device="cpu")


@pytest.mark.parametrize("ckpt", [None, "missing.pth"])
def test_policy_without_checkpoint_takes_the_followers_action(ckpt,
                                                              tmp_path):
    kw = dict(forward_step=0.25, turn_angle=10.0)
    path = None if ckpt is None else str(tmp_path / ckpt)
    got = tpol.DdppoPolicy(ckpt_path=path, device="cpu", **kw)
    ref = jpol.DdppoPolicy(ckpt_path=path, **kw)
    assert not got.learned and got.net is None
    rng = np.random.default_rng(4)
    for _ in range(20):
        yaw = rng.uniform(-np.pi, np.pi)
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]]
        c2w[:3, 3] = [rng.uniform(-2, 2), 1.25, rng.uniform(-2, 2)]
        goal = tuple(rng.uniform(-3, 3, 2))
        depth = np.zeros((8, 8, 1), np.float32)
        assert got.plan(depth, goal, c2w=c2w) == ref.plan(depth, goal,
                                                          c2w=c2w)
    with pytest.raises(ValueError):
        got.plan(np.zeros((8, 8, 1), np.float32), (1.0, 0.0))


def test_path_follower_rollout_matches_jax():
    rng = np.random.default_rng(5)
    for stop in (0.2, 0.5):
        got = tpol.PathFollower(forward_step=0.2, turn_angle=15.0,
                                stop_dist=stop)
        ref = jpol.PathFollower(forward_step=0.2, turn_angle=15.0,
                                stop_dist=stop)
        for _ in range(10):
            c2w = np.eye(4)
            yaw = rng.uniform(-np.pi, np.pi)
            c2w[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                           [-np.sin(yaw), 0, np.cos(yaw)]]
            goal = tuple(rng.uniform(-3, 3, 2))
            acts = got.rollout(c2w, goal, max_actions=60)
            assert acts == ref.rollout(c2w, goal, max_actions=60)
            assert 0 < len(acts) <= 60


def test_learned_policy_acts_as_the_jax_one(params):
    """DdppoPolicy with the network (injected at 64x64, as the JAX
    package's test does: the loader's default input is 256x256) takes the
    JAX policy's deterministic actions over an episode's first steps."""
    got = tpol.DdppoPolicy(device="cpu", deterministic=True)
    ref = jpol.DdppoPolicy(deterministic=True)
    got.net, got.hidden_size, got.learned = (
        tnet.from_params(params, HID, HW, device="cpu"), HID, True)
    ref.params, ref.hidden_size, ref.learned = params, HID, True
    got.reset()
    ref.reset()
    rng = np.random.default_rng(6)
    c2w = np.eye(4)
    c2w[:3, 3] = [0.3, 1.25, -0.2]
    for t in range(3):
        depth = rng.uniform(0, 1, (HW, HW)).astype(np.float32)
        goal = (1.5 - t, 2.0)
        assert got.plan(depth, goal, c2w=c2w) == ref.plan(depth, goal,
                                                          c2w=c2w)
        assert got._t == t + 1
    got.reset()
    assert int(got._prev_action[0]) == 0 and got._t == 0
