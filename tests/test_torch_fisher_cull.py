"""K3's per-warp culling and thread -> pixel map, on the CPU.

The K3 kernel (csrc/fisher.cu) gives each warp a compact 8x8 patch of the
tile (`cuda_fisher.fisher_warp_pixels`) and skips, per warp, the rows whose
conservative pixel box (`cuda_fisher.fisher_row_boxes`, blend_common.cuh's
row_box without a valid column) misses the patch.  That is exact only if
no pair for which the pair test gives alpha > 0 lies outside its row's box.
These tests hold the box against `cuda_fisher._chunk_alpha`, the twin's
pair test, on rows drawn by hypothesis (pixels on and around the ellipse's
edge and the box's corners, opacity near 1/255) at the 11- and 20-wide
layouts, and on the K3 tests' scenes; and check that the pixel map is a
permutation of the tile's pixels made of compact patches.  No tolerance:
containment must hold for every pair.
"""
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings

from fisher_nerf_customized_tpu_torch.ops import cuda_fisher
from fisher_nerf_customized_tpu_torch.ops.rasterize import tile_pixel_coords

from test_torch_blend_cull import ALPHA_MIN, _edge_pixels, ellipse_rows
from test_torch_fisher_one_walk import kernel_inputs


def _row(nf, mx, my, a, b, c, op):
    r = np.zeros(nf, np.float32)
    r[:11] = [mx, my, a, b, c, op, 2.0, 0.1, -0.2, 2.0, 1.5]
    r[11:] = 0.5
    return r


def _assert_live_inside(row, px, py):
    packed = torch.from_numpy(row)[None, None, :]                 # (1, 1, NF)
    pxt = torch.from_numpy(np.asarray(px, np.float32))[None, None, :]
    pyt = torch.from_numpy(np.asarray(py, np.float32))[None, None, :]
    alpha, _g, _dx, _dy = cuda_fisher._chunk_alpha(packed, pxt, pyt)
    box = cuda_fisher.fisher_row_boxes(packed)[0, 0].numpy()
    px, py = pxt[0, 0].numpy(), pyt[0, 0].numpy()
    live = alpha[0, 0].numpy() > 0
    inside = (px >= box[0]) & (px <= box[1]) & (py >= box[2]) & (py <= box[3])
    bad = live & ~inside
    assert not bad.any(), (
        f"row {row[:6].tolist()} box {box.tolist()}: live pairs outside at "
        f"{list(zip(px[bad].tolist(), py[bad].tolist()))[:4]}")
    return live, box


@pytest.mark.parametrize("nf", [11, 20])
@settings(max_examples=200, deadline=None, derandomize=True)
@given(ellipse_rows())
@example((100.25, 37.5, 0.5, 0.0, 0.5, 0.9))
@example((10.0, 10.0, 2.0, 1.999, 2.0, 0.5))            # a c / det = 1000
@example((0.0, 0.0, 1e-3, 0.0, 1e-3, ALPHA_MIN * (1 + 1e-6)))
def test_fisher_row_box_contains_every_live_pair(nf, params):
    row = _row(nf, *params)
    mx, my, a, b, c, op = (float(x) for x in row[:6])          # float32 values
    if a * c - b * b <= 0:          # rounding made the drawn conic singular
        return
    px, py = _edge_pixels(mx, my, a, b, c, op,
                          scales=(0.0, 0.5, 0.99, 0.999, 0.9999, 1.0, 1.0001,
                                  1.001, 1.01), n_dir=64)
    live, box = _assert_live_inside(row, px, py)
    assert live[0], "the centre of a row with opacity >= 1/255 blends"
    # the box's corners and the points just inside and outside its edges
    x0, x1, y0, y1 = (float(v) for v in box)
    eps = np.array([-1e-3, 0.0, 1e-3])
    cx = np.concatenate([x0 + eps, x1 + eps, np.full(6, mx), [x0, x1, x0, x1]])
    cy = np.concatenate([np.full(6, my), y0 + eps, y1 + eps, [y0, y0, y1, y1]])
    _assert_live_inside(row, cx, cy)


@pytest.mark.parametrize("nf", [11, 20])
@pytest.mark.parametrize("op", [0.0, ALPHA_MIN * 0.999, float("nan")])
def test_fisher_row_box_is_empty_where_no_pair_blends(nf, op):
    """An invalid row (opacity 0, K3's layout has no valid column), an
    opacity below 1/255 or a NaN opacity: empty box, no live pair."""
    row = _row(nf, 5.0, 5.0, 0.2, 0.05, 0.3, op)
    gx, gy = np.meshgrid(np.arange(-10, 20), np.arange(-10, 20))
    live, box = _assert_live_inside(row, gx.ravel(), gy.ravel())
    assert box[0] > box[1] and box[2] > box[3] and not live.any()


@pytest.mark.parametrize("p", [256, 512, 1024])
def test_fisher_warp_pixels_are_compact_patches(p):
    """A permutation of the tile's pixels; each warp's 64 pixels fill an
    8x8 square, and each lane's 2 a horizontal pair."""
    tw = 16 if p == 256 else 32
    warp_px = cuda_fisher.fisher_warp_pixels(p)
    assert warp_px.shape == (p // 64, 64)
    assert sorted(warp_px.reshape(-1).tolist()) == list(range(p))
    x, y = warp_px % tw, warp_px // tw
    for w in range(warp_px.shape[0]):
        assert int(x[w].max() - x[w].min()) == 7
        assert int(y[w].max() - y[w].min()) == 7
        assert x[w, 0] % 8 == 0 and y[w, 0] % 8 == 0
    pairs = warp_px.reshape(-1, 2)
    qx, qy = pairs % tw, pairs // tw
    assert ((qx[:, 1] - qx[:, 0]) == 1).all() and (qy[:, 1] == qy[:, 0]).all()


@pytest.mark.parametrize("p", [256, 1024])
def test_fisher_warp_patches_on_tile_coords(p):
    """On the coordinates of a real tile (tile_pixel_coords), each warp's
    patch spans 8x8 pixels."""
    ts = int(round(p ** 0.5))
    pix_x, pix_y = tile_pixel_coords(2, 2, ts)
    perm = cuda_fisher.fisher_warp_pixels(p)
    for t in range(4):
        wx, wy = pix_x[t][perm], pix_y[t][perm]
        assert ((wx.amax(1) - wx.amin(1)) == 7).all()
        assert ((wy.amax(1) - wy.amin(1)) == 7).all()


@pytest.mark.parametrize("kind", ["sparse", "saturating"])
@pytest.mark.parametrize("full_chain", [False, True])
def test_fisher_warp_culling_skips_only_dead_pairs(kind, full_chain):
    """On the K3 tests' scenes: every (pixel, row) pair that blends lies in
    a warp patch that the row's box reaches; and on the sparse scene the
    test culls something (the wall's Gaussians span whole tiles)."""
    packed, pix_xy, nvalid = (torch.from_numpy(x)
                              for x in kernel_inputs(kind, full_chain))
    nb, n_tiles, k, nf = packed.shape
    rows = packed.reshape(-1, k, nf)
    pix = pix_xy.repeat(nb, 1, 1)
    alpha, _g, _dx, _dy = cuda_fisher._chunk_alpha(
        rows, pix[:, 0, None, :], pix[:, 1, None, :])             # (R, K, P)
    hits = cuda_fisher.fisher_warp_hits(cuda_fisher.fisher_row_boxes(rows),
                                        pix)                      # (R, K, W)
    # per pixel: does the box test keep the pair's row for the pixel's warp?
    owner = torch.empty(pix.shape[-1], dtype=torch.long)
    warp_px = cuda_fisher.fisher_warp_pixels(pix.shape[-1])
    owner[warp_px.reshape(-1)] = torch.arange(
        warp_px.shape[0]).repeat_interleave(warp_px.shape[1])
    kept = hits[..., owner]                                       # (R, K, P)
    live = alpha > 0
    assert live.any()
    assert not (live & ~kept).any()
    valid = torch.arange(k)[None, :, None] < nvalid.reshape(-1)[:, None, None]
    if kind == "sparse":
        assert (valid & ~hits).any(), "the box test culls no valid row"
