"""RRT and RRT* sampling planners over the occupancy map.

The port's own copy of the JAX package's planning/rrt.py (numpy only;
the reference's planning/rrt.py RRT and planning/rrt_star.py RRTStar):
steer / nearest / map collision check, choose_parent / rewire, and the
exploration mode that returns every horizon-long root-connected path for
UPEN's disagreement scoring.  Nodes are kept in a list; nearest and near
queries are vectorized over it.  The caller's np.random.Generator makes
the draws, so the same generator state gives the JAX package's tree.
"""
from __future__ import annotations

import math

import numpy as np


class RRT:
    class Node:
        def __init__(self, x, y):
            self.x = float(x)
            self.y = float(y)
            self.path_x: list[float] = []
            self.path_y: list[float] = []
            self.parent = None
            self.cost = 0.0

    def __init__(self, start, goal, occupancy_map, rand_area,
                 expand_dis: float = 3.0, path_resolution: float = 0.5,
                 goal_sample_rate: int = 5, max_iter: int = 500, rng=None):
        """occupancy_map: (H, W) array, nonzero = obstacle; coordinates are
        (x=col, y=row) like the reference's map frame."""
        self.start = self.Node(*start)
        self.end = self.Node(*goal)
        self.occupancy_map = np.asarray(occupancy_map)
        self.min_rand, self.max_rand = rand_area
        self.expand_dis = expand_dis
        self.path_resolution = path_resolution
        self.goal_sample_rate = goal_sample_rate
        self.max_iter = max_iter
        self.rng = rng or np.random.default_rng()
        self.node_list: list[RRT.Node] = []

    # -- geometry helpers ----------------------------------------------------
    @staticmethod
    def calc_distance_and_angle(a: "RRT.Node", b: "RRT.Node"):
        dx, dy = b.x - a.x, b.y - a.y
        return math.hypot(dx, dy), math.atan2(dy, dx)

    def steer(self, from_node, to_node, extend_length=float("inf")):
        new_node = self.Node(from_node.x, from_node.y)
        d, theta = self.calc_distance_and_angle(new_node, to_node)
        new_node.path_x, new_node.path_y = [new_node.x], [new_node.y]
        extend_length = min(extend_length, d)
        n_expand = int(extend_length // self.path_resolution)
        for _ in range(n_expand):
            new_node.x += self.path_resolution * math.cos(theta)
            new_node.y += self.path_resolution * math.sin(theta)
            new_node.path_x.append(new_node.x)
            new_node.path_y.append(new_node.y)
        d_rem, _ = self.calc_distance_and_angle(new_node, to_node)
        if d_rem <= self.path_resolution:
            new_node.path_x.append(to_node.x)
            new_node.path_y.append(to_node.y)
            new_node.x, new_node.y = to_node.x, to_node.y
        new_node.parent = from_node
        return new_node

    def get_random_node(self):
        if self.rng.integers(0, 100) > self.goal_sample_rate:
            return self.Node(self.rng.uniform(self.min_rand, self.max_rand),
                             self.rng.uniform(self.min_rand, self.max_rand))
        return self.Node(self.end.x, self.end.y)

    @staticmethod
    def get_nearest_node_index(node_list, rnd):
        xy = np.array([[n.x, n.y] for n in node_list])
        return int(np.argmin((xy[:, 0] - rnd.x) ** 2 + (xy[:, 1] - rnd.y) ** 2))

    def check_collision_map(self, node) -> bool:
        """True if the node's whole swept path is free (reference
        rrt.py:213 check_collision_map)."""
        if node is None:
            return False
        h, w = self.occupancy_map.shape
        for x, y in zip(node.path_x, node.path_y):
            ix, iy = int(round(x)), int(round(y))
            if ix < 0 or iy < 0 or ix >= w or iy >= h:
                return False
            if self.occupancy_map[iy, ix]:
                return False
        return True

    def calc_dist_to_goal(self, x, y):
        return math.hypot(x - self.end.x, y - self.end.y)

    def generate_final_course(self, goal_ind):
        path = [[self.end.x, self.end.y]]
        node = self.node_list[goal_ind]
        while node.parent is not None:
            path.append([node.x, node.y])
            node = node.parent
        path.append([node.x, node.y])
        return path

    def planning(self, animation: bool = False):
        self.node_list = [self.start]
        for _i in range(self.max_iter):
            rnd = self.get_random_node()
            nearest = self.node_list[self.get_nearest_node_index(
                self.node_list, rnd)]
            new_node = self.steer(nearest, rnd, self.expand_dis)
            if self.check_collision_map(new_node):
                self.node_list.append(new_node)
                if self.calc_dist_to_goal(new_node.x, new_node.y) \
                        <= self.expand_dis:
                    final = self.steer(new_node, self.end, self.expand_dis)
                    if self.check_collision_map(final):
                        self.node_list.append(final)
                        return self.generate_final_course(
                            len(self.node_list) - 1)
        return None


class RRTStar(RRT):
    def __init__(self, start, goal, occupancy_map, rand_area,
                 expand_dis: float = 3.0, path_resolution: float = 0.5,
                 goal_sample_rate: int = 5, max_iter: int = 500,
                 connect_circle_dist: float = 50.0,
                 search_until_max_iter: bool = False, rng=None):
        super().__init__(start, goal, occupancy_map, rand_area, expand_dis,
                         path_resolution, goal_sample_rate, max_iter, rng)
        self.connect_circle_dist = connect_circle_dist
        self.search_until_max_iter = search_until_max_iter

    def find_near_nodes(self, new_node):
        n = len(self.node_list) + 1
        r = self.connect_circle_dist * math.sqrt(math.log(n) / n)
        r = min(r, self.expand_dis * 5.0)
        xy = np.array([[nd.x, nd.y] for nd in self.node_list])
        d2 = (xy[:, 0] - new_node.x) ** 2 + (xy[:, 1] - new_node.y) ** 2
        return list(np.nonzero(d2 <= r ** 2)[0])

    def choose_parent(self, new_node, near_inds):
        if not near_inds:
            return None
        costs = []
        for i in near_inds:
            near = self.node_list[i]
            t = self.steer(near, new_node)
            costs.append(near.cost + math.hypot(new_node.x - near.x,
                                                new_node.y - near.y)
                         if self.check_collision_map(t) else float("inf"))
        min_cost = min(costs)
        if min_cost == float("inf"):
            return None
        best = near_inds[int(np.argmin(costs))]
        out = self.steer(self.node_list[best], new_node)
        out.cost = min_cost
        return out

    def rewire(self, new_node, near_inds):
        for i in near_inds:
            near = self.node_list[i]
            edge = self.steer(new_node, near)
            if not edge:
                continue
            edge.cost = new_node.cost + math.hypot(near.x - new_node.x,
                                                   near.y - new_node.y)
            if self.check_collision_map(edge) and near.cost > edge.cost:
                near.x, near.y = edge.x, edge.y
                near.cost = edge.cost
                near.path_x, near.path_y = edge.path_x, edge.path_y
                near.parent = edge.parent
                self._propagate_cost(near)

    def _propagate_cost(self, parent):
        for node in self.node_list:
            if node.parent is parent:
                node.cost = parent.cost + math.hypot(node.x - parent.x,
                                                     node.y - parent.y)
                self._propagate_cost(node)

    def search_best_goal_node(self):
        dists = [self.calc_dist_to_goal(n.x, n.y) for n in self.node_list]
        goal_inds = [i for i, d in enumerate(dists) if d <= self.expand_dis]
        safe = []
        for i in goal_inds:
            t = self.steer(self.node_list[i], self.end)
            if self.check_collision_map(t):
                safe.append(i)
        if not safe:
            return None
        costs = [self.node_list[i].cost + dists[i] for i in safe]
        return safe[int(np.argmin(costs))]

    def planning(self, animation: bool = False, use_straight_line: bool = False,
                 exploration: bool = False, horizon: int = 10):
        """RRT* search; `exploration=True` returns ALL horizon-length
        root-connected paths for ensemble reachability scoring (reference
        rrt_star.py:59-131)."""
        self.node_list = [self.start]
        for _i in range(self.max_iter):
            rnd = self.get_random_node()
            nearest_ind = self.get_nearest_node_index(self.node_list, rnd)
            new_node = self.steer(self.node_list[nearest_ind], rnd,
                                  self.expand_dis)
            near = self.node_list[nearest_ind]
            new_node.cost = near.cost + math.hypot(new_node.x - near.x,
                                                   new_node.y - near.y)
            if self.check_collision_map(new_node):
                near_inds = self.find_near_nodes(new_node)
                updated = self.choose_parent(new_node, near_inds)
                if updated:
                    self.rewire(updated, near_inds)
                    self.node_list.append(updated)
                else:
                    self.node_list.append(new_node)
            if not exploration and not self.search_until_max_iter:
                last = self.search_best_goal_node()
                if last is not None:
                    return self.generate_final_course(last)

        if exploration:
            valid_paths = []
            for node in self.node_list:
                cur, path, skip = node, [], False
                for _ in range(horizon):
                    if cur.parent:
                        path.append([cur.x, cur.y])
                        cur = cur.parent
                    else:
                        skip = True
                if cur is self.start and not skip:
                    valid_paths.append(path)
            return valid_paths
        last = self.search_best_goal_node()
        return self.generate_final_course(last) if last is not None else None
