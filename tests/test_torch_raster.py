"""utils/raster.py, the port's cv2-free raster operations, against OpenCV
(cv2, which the JAX package uses) on hypothesis grids and shapes.

Tolerance: exact, cell for cell, everywhere (label numbers included:
label8 reproduces cv2's numbering), fill_poly's cells on the grid's
border included where a polygon's edge leaves the grid.  Thick lines
are drawn between cells of the grid, as the planner's collision check
draws them.
"""
import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fisher_nerf_customized_tpu.planning.astar import (
    check_collision_free as jax_check_collision_free)
from fisher_nerf_customized_tpu_torch.planning.astar import (
    check_collision_free)
from fisher_nerf_customized_tpu_torch.utils import raster

K3 = np.ones((3, 3), np.uint8)
SETTINGS = settings(max_examples=60, deadline=None)


@st.composite
def grids(draw, min_side=3, max_side=48):
    h = draw(st.integers(min_side, max_side))
    w = draw(st.integers(min_side, max_side))
    density = draw(st.sampled_from([0.1, 0.5, 0.8, 0.97]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(h, w)) < density).astype(np.uint8)


def points(w, h, margin=0):
    return st.tuples(st.integers(-margin, w - 1 + margin),
                     st.integers(-margin, h - 1 + margin))


@SETTINGS
@given(grids())
def test_square_morphology_matches_cv2(g):
    np.testing.assert_array_equal(raster.dilate3(g), cv2.dilate(g, K3))
    np.testing.assert_array_equal(raster.erode3(g), cv2.erode(g, K3))
    np.testing.assert_array_equal(raster.open3(g),
                                  cv2.morphologyEx(g, cv2.MORPH_OPEN, K3))


@SETTINGS
@given(grids(), st.sampled_from([2, 4, 10, 11]))
def test_square_erosion_keeps_cv2s_anchor(g, k):
    """An even kernel is anchored at k // 2, as cv2 anchors it."""
    np.testing.assert_array_equal(
        raster.erode_square(g, k), cv2.erode(g, np.ones((k, k), np.uint8)))


@pytest.mark.parametrize("k", range(1, 22))
def test_ellipse_kernel_matches_cv2(k):
    np.testing.assert_array_equal(
        raster.ellipse_kernel(k),
        cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)))


@SETTINGS
@given(grids(), st.sampled_from([3, 5, 9, 13]))
def test_elliptic_dilation_matches_cv2(g, k):
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
    np.testing.assert_array_equal(raster.dilate(g, raster.ellipse_kernel(k)),
                                  cv2.dilate(g, kernel))


@SETTINGS
@given(grids(), st.data())
def test_filled_circle_matches_cv2(g, data):
    h, w = g.shape
    center = data.draw(points(w, h, margin=6))
    r = data.draw(st.integers(0, 9))
    ref = np.zeros((h, w), np.uint8)
    cv2.circle(ref, center, r, 1, -1)
    np.testing.assert_array_equal(raster.fill_circle((h, w), center, r), ref)


@SETTINGS
@given(grids(max_side=64))
def test_components_match_cv2_with_its_numbering(g):
    n, labels, areas = raster.label8(g)
    ref_n, ref = cv2.connectedComponents(g)
    assert n == ref_n
    np.testing.assert_array_equal(labels, ref)
    _n, ref2, stats, _c = cv2.connectedComponentsWithStats(g)
    np.testing.assert_array_equal(labels, ref2)
    np.testing.assert_array_equal(areas, stats[:, 4])


@SETTINGS
@given(grids())
def test_l1_distance_matches_cv2(g):
    g = g.copy()
    g[0, 0] = 0                      # at least one zero cell
    got = raster.distance_l1(g)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, cv2.distanceTransform(g, cv2.DIST_L1,
                                                             5))


@SETTINGS
@given(st.integers(8, 60), st.integers(8, 60), st.data(),
       st.sampled_from([2, 3, 7]))
def test_thick_line_matches_cv2(h, w, data, thickness):
    p0 = data.draw(points(w, h))
    p1 = data.draw(points(w, h))
    ref = np.zeros((h, w), np.uint8)
    cv2.line(ref, p0, p1, 1, thickness)
    mask, y0, x0 = raster.thick_line_box(p0, p1, thickness, (h, w))
    box = np.zeros((h, w), np.uint8)
    box[y0:y0 + mask.shape[0], x0:x0 + mask.shape[1]] = mask
    np.testing.assert_array_equal(box, ref)


@SETTINGS
@given(grids(min_side=8), st.data())
def test_collision_check_matches_jax(g, data):
    h, w = g.shape
    occ = (g == 0).astype(np.uint8)
    p0, p1 = data.draw(points(w, h)), data.draw(points(w, h))
    assert check_collision_free(p0, p1, occ) == \
        jax_check_collision_free(p0, p1, occ)


def _wedge(cx, cy, yaw, r):
    """The fog-of-war wedge of engine/visualization.py."""
    return np.asarray([(cx, cy)] + [
        (int(cx + r * np.sin(a)), int(cy + r * np.cos(a)))
        for a in np.linspace(yaw - np.pi / 4, yaw + np.pi / 4, 24)], np.int32)


@SETTINGS
@given(st.integers(8, 60), st.integers(8, 60), st.data())
def test_fill_poly_matches_cv2_inside_the_grid(h, w, data):
    n = data.draw(st.integers(3, 7))
    poly = np.asarray([data.draw(points(w, h)) for _ in range(n)], np.int32)
    ref = np.zeros((h, w), np.uint8)
    cv2.fillPoly(ref, [poly], 1)
    np.testing.assert_array_equal(raster.fill_poly((h, w), poly), ref)


@SETTINGS
@given(st.integers(8, 60), st.integers(8, 60), st.data())
def test_fill_poly_wedges_differ_only_on_the_border(h, w, data):
    # the name is kept from when the border cells could differ; the fill
    # now equals cv2's on every cell, edges that leave the grid included
    cx, cy = data.draw(points(w, h))
    yaw = data.draw(st.floats(0.0, 2 * np.pi))
    r = data.draw(st.integers(2, 70))
    poly = _wedge(cx, cy, yaw, r)
    ref = np.zeros((h, w), np.uint8)
    cv2.fillPoly(ref, [poly], 1)
    np.testing.assert_array_equal(raster.fill_poly((h, w), poly), ref)
