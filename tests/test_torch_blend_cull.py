"""The per-warp culling predicate of the CUDA blend kernels, on the CPU.

Both blend kernels (csrc/blend.cu, csrc/blend_bwd.cu) skip, per warp, the
rows whose conservative pixel box (csrc/blend_common.cuh::row_box) misses
the warp's pixels.  That is exact only if no pair for which the pair test
gives alpha > 0 lies outside its row's box.  `cuda_blend.row_boxes` is the
plain form of the box in float32; these tests hold it against
`cuda_blend._pair_alpha`, the twins' pair test, on rows drawn by
hypothesis (pixels on and around the ellipse's edge and the box's
corners, opacity near 1/255, det <= 0, NaN fields) and on the blend
tests' scenes.  No tolerance: containment must hold for every pair.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from fisher_nerf_customized_tpu_torch.ops import cuda_blend

from test_torch_blend import scene

F = 12          # packed row of 8 + 4 colors
ALPHA_MIN = 1.0 / 255.0


def _row(mx, my, a, b, c, op, valid=1.0):
    r = np.zeros(F, np.float32)
    r[:8] = [mx, my, a, b, c, op, 2.0, valid]
    return r


def _alpha_and_box(row, px, py):
    """alpha (P,) of one row at pixels (px, py), and the row's box."""
    packed = torch.from_numpy(row)[None, None, :]                 # (1, 1, F)
    pxt = torch.from_numpy(np.asarray(px, np.float32))[None, None, :]
    pyt = torch.from_numpy(np.asarray(py, np.float32))[None, None, :]
    alpha, _g, _dx, _dy = cuda_blend._pair_alpha(packed, pxt, pyt)
    box = cuda_blend.row_boxes(packed)[0, 0].numpy()
    return alpha[0, 0].numpy(), box, pxt[0, 0].numpy(), pyt[0, 0].numpy()


def _assert_live_inside(row, px, py):
    alpha, box, px, py = _alpha_and_box(row, px, py)
    live = alpha > 0
    inside = (px >= box[0]) & (px <= box[1]) & (py >= box[2]) & (py <= box[3])
    bad = live & ~inside
    assert not bad.any(), (
        f"row {row[:8].tolist()} box {box.tolist()}: live pairs outside at "
        f"{list(zip(px[bad].tolist(), py[bad].tolist()))[:4]}")
    return live, box


def _edge_pixels(mx, my, a, b, c, op, scales, n_dir):
    """Pixels on scaled copies of the exact alpha = 1/255 ellipse
    d^T Q d = 2 ln(255 op) around (mx, my)."""
    q = np.array([[a, b], [b, c]], np.float64)
    r2 = 2.0 * math.log(255.0 * op)
    lam, vec = np.linalg.eigh(q)
    phi = np.linspace(0.0, 2.0 * math.pi, n_dir, endpoint=False)
    u = np.stack([np.cos(phi), np.sin(phi)])                    # (2, n)
    d = vec @ (u / np.sqrt(lam)[:, None]) * math.sqrt(r2)      # on the edge
    pts = np.concatenate([d * s for s in scales], axis=1)
    return mx - pts[0], my - pts[1]


@st.composite
def ellipse_rows(draw):
    """A positive-definite conic (eigenvalues up to 1000 apart, any
    rotation), a centre anywhere on a 256-pixel image or off it, and an
    opacity either anywhere in [1/255, 1] or just above 1/255."""
    lam1 = 10.0 ** draw(st.floats(-3.0, 1.0))
    lam2 = lam1 * 10.0 ** draw(st.floats(0.0, 3.0))
    th = draw(st.floats(0.0, math.pi))
    cs, sn = math.cos(th), math.sin(th)
    a = lam1 * cs * cs + lam2 * sn * sn
    c = lam1 * sn * sn + lam2 * cs * cs
    b = (lam2 - lam1) * cs * sn
    near_min = draw(st.booleans())
    op = (ALPHA_MIN * (1.0 + 10.0 ** draw(st.floats(-6.0, -2.0)))
          if near_min else draw(st.floats(ALPHA_MIN * 1.01, 1.0)))
    mx = draw(st.floats(-300.0, 600.0))
    my = draw(st.floats(-300.0, 600.0))
    return mx, my, a, b, c, op


@settings(max_examples=300, deadline=None, derandomize=True)
@given(ellipse_rows())
@example((100.25, 37.5, 0.5, 0.0, 0.5, 0.9))
@example((10.0, 10.0, 2.0, 1.999, 2.0, 0.5))            # a c / det = 1000
@example((0.0, 0.0, 1e-3, 0.0, 1e-3, ALPHA_MIN * (1 + 1e-6)))
def test_row_box_contains_every_live_pair(params):
    mx, my, a, b, c, op = params
    row = _row(mx, my, a, b, c, op)
    mx, my, a, b, c, op = (float(x) for x in row[:6])          # float32 values
    if a * c - b * b <= 0:          # rounding made the drawn conic singular
        return
    px, py = _edge_pixels(mx, my, a, b, c, op,
                          scales=(0.0, 0.5, 0.99, 0.999, 0.9999, 1.0, 1.0001,
                                  1.001, 1.01), n_dir=64)
    live, box = _assert_live_inside(row, px, py)
    assert live[0], "the centre of a row with opacity >= 1/255 blends"
    # the box's corners and the points just inside its edges
    x0, x1, y0, y1 = (float(v) for v in box)
    eps = np.array([-1e-3, 0.0, 1e-3])
    cx = np.concatenate([x0 + eps, x1 + eps, np.full(3, mx)])
    cy = np.concatenate([np.full(3, my), np.full(3, my), y0 + eps])
    _assert_live_inside(row, np.concatenate([cx, np.full(3, mx)]),
                        np.concatenate([cy, y1 + eps]))
    # not vacuous: the box is finite and no wider than the ellipse with
    # 2 % more r2 (+2e-5 absolute), 1 % more half-width and 0.02 pixel
    if a * c <= 999.0 * (a * c - b * b):
        r2 = 1.02 * max(2.0 * math.log(255.0 * op), 0.0) + 2e-5
        det = a * c - b * b
        assert x1 - mx <= 1.01 * math.sqrt(r2 * c / det) + 0.02 + 2e-6 * abs(mx)
        assert y1 - my <= 1.01 * math.sqrt(r2 * a / det) + 0.02 + 2e-6 * abs(my)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(a=st.floats(-2.0, 2.0), b=st.floats(-2.0, 2.0), c=st.floats(-2.0, 2.0),
       op=st.floats(0.0, 1.0))
def test_row_box_is_unbounded_or_empty_where_it_must_be(a, b, c, op):
    """Any conic, including det <= 0 or a <= 0 (an unbounded region): the
    box is infinite there, empty for opacity below 1/255, and always holds
    the live pairs on a grid of pixels around the centre."""
    row = _row(3.0, -4.0, a, b, c, op)
    gx, gy = np.meshgrid(np.linspace(-40, 40, 33), np.linspace(-40, 40, 33))
    live, box = _assert_live_inside(row, 3.0 + gx.ravel(), -4.0 + gy.ravel())
    a32, b32, c32, op32 = (float(x) for x in row[2:6])
    if op32 * 1.0001 < ALPHA_MIN:
        assert box[0] > box[1] and not live.any()
    elif not (a32 * c32 - b32 * b32 > 0 and a32 > 0):
        assert np.isneginf(box[0]) and np.isposinf(box[1])


@pytest.mark.parametrize("field", range(8))
def test_row_box_of_a_nan_row(field):
    """A NaN in any field: no pair blends, and the box holds that."""
    row = _row(5.0, 5.0, 0.2, 0.05, 0.3, 0.8)
    row[field] = np.nan
    gx, gy = np.meshgrid(np.arange(-10, 20), np.arange(-10, 20))
    live, _box = _assert_live_inside(row, gx.ravel(), gy.ravel())
    if field not in (6,):            # depth takes no part in alpha
        assert not live.any()


def test_row_box_of_an_invalid_row_is_empty():
    row = _row(5.0, 5.0, 0.2, 0.05, 0.3, 0.8, valid=0.0)
    box = cuda_blend.row_boxes(torch.from_numpy(row)[None, None])[0, 0]
    assert box[0] > box[1] and box[2] > box[3]


@pytest.mark.parametrize("kind", ["random", "opaque_wall", "corner"])
@pytest.mark.parametrize("warp_pixels", [16, 32])
def test_warp_culling_skips_only_dead_pairs(kind, warp_pixels):
    """On the blend tests' scenes: every (pixel, row) pair that blends lies
    in a warp that the row's box reaches, for warps of 32 pixels (K1) and
    of 16 (K2, two lanes per pixel); and the test culls something."""
    packed, pix_xy, nvalid = (torch.from_numpy(np.array(x)) for x in scene(
        kind, {"random": 0, "opaque_wall": 2, "corner": 5}[kind], 4))
    px, py = pix_xy[:, 0, None, :], pix_xy[:, 1, None, :]
    alpha, _g, _dx, _dy = cuda_blend._pair_alpha(packed, px, py)  # (T, K, P)
    hits = cuda_blend.warp_hits(cuda_blend.row_boxes(packed), pix_xy,
                                warp_pixels)                      # (T, K, W)
    per_pixel = hits.repeat_interleave(warp_pixels, dim=-1)
    live = alpha > 0
    assert live.any()
    assert not (live & ~per_pixel).any()
    rows = torch.arange(packed.shape[1])[None, :, None] < nvalid[:, None, None]
    assert (rows & ~hits).any(), "the box test culls no valid row"
