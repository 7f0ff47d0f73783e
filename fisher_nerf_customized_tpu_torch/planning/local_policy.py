"""Local waypoint-following policies.

Counterpart of the JAX package's planning/local_policy.py (the
reference's PathFollower and DdppoPolicy).  `PathFollower` is a numpy
copy: a greedy geometric follower.  `DdppoPolicy` runs the DD-PPO
pointgoal network (planning/ddppo_net.py) on its device when a habitat
checkpoint loads; none is in the repository, and without one (or with
one that does not load) it logs a warning and takes the follower's
action, as the JAX package does.
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..utils.geometry import compute_next_campos

logger = logging.getLogger(__name__)


class PathFollower:
    """Greedy geometric follower: turn toward the goal until it lies
    within one turn angle of the heading, else step forward; STOP within
    `stop_dist`."""

    STOP, FORWARD, LEFT, RIGHT = 0, 1, 2, 3

    def __init__(self, forward_step: float = 0.25, turn_angle: float = 10.0,
                 stop_dist: float = 0.2):
        self.forward_step = float(forward_step)
        self.turn_angle = float(turn_angle)
        self.stop_dist = float(stop_dist)

    def next_action(self, c2w: np.ndarray, goal_world_xz) -> int:
        c2w = np.asarray(c2w, np.float64)
        goal = np.array([goal_world_xz[0], c2w[1, 3], goal_world_xz[-1], 1.0])
        rel = np.linalg.inv(c2w) @ goal
        xz = rel[[0, 2]]
        if np.linalg.norm(xz) < self.stop_dist:
            return self.STOP
        ang = math.atan2(xz[0], xz[1])
        if ang > math.radians(self.turn_angle):
            return self.RIGHT
        if ang < -math.radians(self.turn_angle):
            return self.LEFT
        return self.FORWARD

    def rollout(self, c2w: np.ndarray, goal_world_xz,
                max_actions: int = 50) -> list[int]:
        """The follower's actions from c2w until STOP (at most
        max_actions), each applied to the pose."""
        pose = np.asarray(c2w, np.float64).copy()
        actions = []
        for _ in range(max_actions):
            a = self.next_action(pose, goal_world_xz)
            if a == self.STOP:
                break
            pose = compute_next_campos(pose, a, self.forward_step,
                                       self.turn_angle)
            actions.append(a)
        return actions


class DdppoPolicy:
    """The DD-PPO pointgoal local policy, gated on its checkpoint.

    With a checkpoint that loads, `plan` runs one step of the network on
    `device` ("cuda" by default) per frame and samples the action from a
    torch.Generator seeded with `seed` (the argmax with
    `deterministic`); otherwise `learned` is False and `plan` returns
    PathFollower's action."""

    def __init__(self, ckpt_path: str | None = None, seed: int = 0,
                 deterministic: bool = False, device="cuda",
                 **follower_kwargs):
        self.learned = False
        self.net = None
        self.hidden_size = 0
        self.deterministic = bool(deterministic)
        self.device = torch.device(device)
        if ckpt_path:
            try:
                from . import ddppo_net
                self.net, self.hidden_size = \
                    ddppo_net.load_torch_checkpoint(ckpt_path,
                                                    device=self.device)
                self.learned = True
            except Exception as e:   # a missing file, an incompatible one
                logger.warning("DD-PPO checkpoint unavailable (%s); using "
                               "geometric follower", e)
        self.follower = PathFollower(**follower_kwargs)
        self._seed = int(seed)
        self.reset()

    def _goal_polar(self, pointgoal_rel, c2w):
        """(rho, phi) for the network: the goal as given (already polar),
        or from a world xz goal and the agent's c2w (phi from the camera's
        forward axis, left positive, habitat's convention)."""
        g = np.asarray(pointgoal_rel, np.float64).reshape(-1)
        if c2w is None:
            return np.asarray(g[:2], np.float32)
        c2w = np.asarray(c2w, np.float64)
        goal = np.array([g[0], c2w[1, 3], g[-1], 1.0])
        rel = np.linalg.inv(c2w) @ goal
        rho = float(np.hypot(rel[0], rel[2]))
        phi = float(-math.atan2(rel[0], rel[2]))
        return np.asarray([rho, phi], np.float32)

    def plan(self, depth, pointgoal_rel, c2w=None,
             t: int | None = None) -> int:
        """The action toward a relative (rho, phi) goal or a world xz goal.
        `t` is the episode's step (0 clears the recurrent state through
        the mask); without it an internal counter is used."""
        if self.learned:
            from . import ddppo_net
            step = self._t if t is None else int(t)
            dev = self.device
            d = torch.as_tensor(depth, device=dev).float()
            if d.dim() == 2:
                d = d[..., None]
            goal = torch.as_tensor(self._goal_polar(pointgoal_rel, c2w),
                                   device=dev)
            mask = torch.tensor([0.0 if step == 0 else 1.0], device=dev)
            action, _value, self._hidden = ddppo_net.act(
                self.net, d[None], goal[None], self._hidden,
                self._prev_action, mask, generator=self._gen,
                deterministic=self.deterministic)
            self._prev_action = action
            self._t = step + 1
            return int(action[0])
        if c2w is None:
            raise ValueError("geometric follower needs the agent pose c2w")
        return self.follower.next_action(c2w, pointgoal_rel)

    def reset(self):
        from . import ddppo_net
        self._t = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._seed)
        h = self.hidden_size if self.learned else 1
        self._hidden = ddppo_net.zero_state(h, device=self.device)
        self._prev_action = torch.zeros((1,), dtype=torch.int32,
                                        device=self.device)
