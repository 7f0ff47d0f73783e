"""UPEN's planners, the port against the JAX package: RRT and RRT* (the
port's copy of the numpy module) grow the same trees and return the same
paths from the same generator seed; FrontierSearch, whose cv2 connected
components and dilation the port replaces by utils/raster.py, gives the
same frontiers (sizes, distances, cells, travel points, in the same
order: label order breaks ties of the stable sort) and the same goals on
hypothesis grids, exact.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fisher_nerf_customized_tpu.planning import frontier_search as jfs
from fisher_nerf_customized_tpu.planning import rrt as jrrt
from fisher_nerf_customized_tpu_torch.planning import frontier_search as tfs
from fisher_nerf_customized_tpu_torch.planning import rrt as trrt

SETTINGS = settings(max_examples=60, deadline=None)


def corridor_map(h=64, w=64):
    occ = np.zeros((h, w), np.uint8)
    occ[:4, :] = 1
    occ[-4:, :] = 1
    occ[:, :4] = 1
    occ[:, -4:] = 1
    occ[28:36, 4:48] = 1                    # a wall with a gap on the right
    return occ


def tree(planner):
    """Each node's position, cost, swept path and parent index."""
    index = {id(n): i for i, n in enumerate(planner.node_list)}
    return [(n.x, n.y, n.cost, list(n.path_x), list(n.path_y),
             None if n.parent is None else index.get(id(n.parent), -1))
            for n in planner.node_list]


@pytest.mark.parametrize("seed", [0, 3])
def test_rrt_grows_the_same_tree(seed):
    occ = corridor_map()
    out = []
    for mod in (jrrt, trrt):
        p = mod.RRT(start=(10, 10), goal=(10, 54), occupancy_map=occ,
                    rand_area=(4, 60), expand_dis=6.0, max_iter=2000,
                    rng=np.random.default_rng(seed))
        out.append((p.planning(), tree(p)))
    assert out[0][0] is not None
    assert out[1] == out[0]


@pytest.mark.parametrize("exploration", [False, True])
def test_rrt_star_grows_the_same_tree(exploration):
    occ = corridor_map()
    out = []
    for mod in (jrrt, trrt):
        p = mod.RRTStar(start=(10, 10), goal=(10, 54), occupancy_map=occ,
                        rand_area=(4, 60), expand_dis=6.0,
                        max_iter=300 if exploration else 1500,
                        search_until_max_iter=exploration,
                        rng=np.random.default_rng(1))
        res = p.planning(exploration=exploration, horizon=5)
        out.append((res, tree(p)))
    assert out[0][0]
    assert out[1] == out[0]


@st.composite
def label_grids(draw, min_side=6, max_side=40):
    """(H, W) VOID / OCCUPIED / FREE labels: free rooms in unknown space
    with walls and noise, and a start cell."""
    h = draw(st.integers(min_side, max_side))
    w = draw(st.integers(min_side, max_side))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 31 - 1)))
    labels = np.zeros((h, w), np.int64)
    for _ in range(draw(st.integers(1, 4))):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        labels[y0:y0 + rng.integers(2, h), x0:x0 + rng.integers(2, w)] = 2
    noise = rng.uniform(size=(h, w))
    labels[noise < draw(st.sampled_from([0.0, 0.05, 0.2]))] = 1
    labels[noise > draw(st.sampled_from([1.0, 0.9, 0.7]))] = 0
    start = (int(rng.integers(0, w)), int(rng.integers(0, h)))
    return labels, start


def probs_of(labels, rng=None):
    """Labels as (3, H, W) probabilities; with rng, random confidences
    (some under the 0.4 VOID threshold)."""
    h, w = labels.shape
    probs = np.full((3, h, w), 0.05, np.float32)
    conf = 0.9 if rng is None else rng.uniform(0.3, 0.95, (h, w))
    for c in range(3):
        probs[c][labels == c] = (conf if np.isscalar(conf)
                                 else conf[labels == c])
    return probs


def frontier_tuples(frontiers):
    return [(f.size, f.min_distance, f.travel_point, f.points)
            for f in frontiers]


@SETTINGS
@given(label_grids(), st.sampled_from([1, 2, 4]), st.booleans())
def test_frontier_search_matches_cv2(grid, min_size, noisy):
    labels, start = grid
    probs = probs_of(labels, np.random.default_rng(7) if noisy else None)
    np.testing.assert_array_equal(tfs.labels_from_probs(probs),
                                  jfs.labels_from_probs(probs))
    pose = np.array([[list(start)]])
    for mode in ("closest", "middle", "centroid"):
        ref = jfs.FrontierSearch(0, probs, min_frontier_size=min_size,
                                 travel_point=mode)
        got = tfs.FrontierSearch(0, probs, min_frontier_size=min_size,
                                 travel_point=mode)
        np.testing.assert_array_equal(got._reachable_free(start),
                                      ref._reachable_free(start))
        assert frontier_tuples(got.searchFrom(pose)) == \
            frontier_tuples(ref.searchFrom(pose))
        for thresh in (0, 4, 9):
            np.testing.assert_array_equal(
                got.nextGoal(pose, np.zeros((1, 3)), min_thresh=thresh),
                ref.nextGoal(pose, np.zeros((1, 3)), min_thresh=thresh))


def test_frontier_ties_follow_cv2_label_order():
    """Two frontiers (the rings around two VOID cells of a walled room)
    at the same distance from the start, whose first cells lie in one
    2x2 block row: cv2's block scan numbers the lower-left one first, a
    row-major scan the other, and the stable sort keeps the label
    order."""
    labels = np.ones((14, 14), np.int64)
    labels[1:13, 0:13] = 2
    labels[4, 2] = 0
    labels[3, 6] = 0
    probs = probs_of(labels)
    pose = np.array([[[6, 9]]])
    ref = jfs.FrontierSearch(0, probs, min_frontier_size=1)
    got = tfs.FrontierSearch(0, probs, min_frontier_size=1)
    fr = got.searchFrom(pose)
    assert len(fr) == 2 and fr[0].min_distance == fr[1].min_distance
    assert fr[0].points[0] == (1, 3) and fr[1].points[0] == (5, 2)
    assert frontier_tuples(fr) == frontier_tuples(ref.searchFrom(pose))
    np.testing.assert_array_equal(got.nextGoal(pose, None),
                                  ref.nextGoal(pose, None))


@SETTINGS
@given(st.integers(1, 5), st.integers(1, 6), st.integers(0, 2 ** 31 - 1))
def test_maximin_and_center_match(n_groups, n_pts, seed):
    rng = np.random.default_rng(seed)
    groups = [rng.normal(size=(rng.integers(1, n_pts + 1), 2))
              for _ in range(n_groups)]
    assert tfs.select_maximin_points(groups) == \
        jfs.select_maximin_points(groups)
    pts = np.concatenate(groups)
    np.testing.assert_array_equal(tfs.approx_min_dist_center(pts),
                                  jfs.approx_min_dist_center(pts))
