"""Raster operations on host grids, in the form OpenCV gives them.

The JAX package's planner and visualizer call OpenCV (cv2) for their
grid morphology, connected components, distance transform and drawing.
The machine that runs the port has no cv2, so each call has its own form
here on numpy and scipy.ndimage, written to give cv2's cells exactly:

  dilate3 / erode3 / open3   3x3 square morphology with cv2's borders
                             (the border never dilates, never erodes);
  erode_square(k)            k x k erosion with cv2's anchor (k // 2);
  ellipse_kernel(k)          getStructuringElement(MORPH_ELLIPSE, (k, k));
  dilate(kernel)             dilation by a centred kernel;
  fill_circle                cv2.circle(..., thickness=-1), LINE_8;
  label8                     connectedComponents(WithStats), 8-connected,
                             with cv2's label numbers (see its docstring);
  distance_l1                distanceTransform(DIST_L1, 5), exact L1;
  draw_lines                 cv2.line(..., thickness 1), LINE_8, many
                             lines at once;
  thick_line_box             cv2.line(..., thickness > 1), LINE_8,
                             between points inside the grid;
  fill_poly                  cv2.fillPoly for one contour, LINE_8;
  write_png                  cv2.imwrite of an 8-bit color PNG.

The drawing functions follow the integer and 16.16 fixed-point
arithmetic of OpenCV's drawing.cpp (Bresenham lines, the convex fill of
a thick line's body with its clipped edges, its round caps, the
edge-list polygon fill with its clipped edges), as OpenCV 5.0 computes
them (fill_poly also where an edge leaves the grid, ROADMAP.md queue 3
item j).  Grids are (H, W) arrays indexed [y, x]; points are (x, y) integers,
as cv2 takes them.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
_SQUARE3 = np.ones((3, 3), bool)


def dilate3(mask) -> np.ndarray:
    """cv2.dilate(mask, np.ones((3, 3))) as uint8 0/1."""
    return ndimage.binary_dilation(np.asarray(mask, bool), _SQUARE3,
                                   border_value=0).astype(np.uint8)


def erode3(mask) -> np.ndarray:
    """cv2.erode(mask, np.ones((3, 3))) as uint8 0/1."""
    return erode_square(mask, 3)


def open3(mask) -> np.ndarray:
    """cv2.morphologyEx(mask, MORPH_OPEN, np.ones((3, 3))) as uint8."""
    return dilate3(erode3(mask))


def erode_square(mask, k: int) -> np.ndarray:
    """cv2.erode(mask, np.ones((k, k))) as uint8 0/1.  cv2 anchors a
    k x k kernel at k // 2, as scipy centres a footprint, also for an even
    k."""
    return ndimage.binary_erosion(np.asarray(mask, bool), np.ones((k, k), bool),
                                  border_value=1).astype(np.uint8)


def ellipse_kernel(k: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)) as uint8."""
    out = np.zeros((k, k), np.uint8)
    r = c = k // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * math.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return out


def dilate(mask, kernel) -> np.ndarray:
    """cv2.dilate(mask, kernel) for an odd, point-symmetric kernel, as
    uint8 0/1."""
    kernel = np.asarray(kernel, bool)
    return ndimage.binary_dilation(np.asarray(mask, bool), kernel,
                                   border_value=0).astype(np.uint8)


def label8(mask):
    """8-connected components of the nonzero cells: (n, labels, areas).

    n counts the background as label 0, as cv2.connectedComponents does;
    labels (H, W) int32; areas (n,) int64, areas[0] the background's (the
    last column of connectedComponentsWithStats).  Label numbers follow
    cv2's block scan: components are numbered in the order of the first
    2x2 block, in row-major order of blocks, that holds one of their
    cells (a 2x2 block never holds two components).  A plain row-major
    scan (scipy's order) numbers two components whose first cells share
    a block row differently."""
    mask = np.asarray(mask, bool)
    labels, n_fg = ndimage.label(mask, structure=_SQUARE3)
    if n_fg > 1:
        ys, xs = np.nonzero(labels)
        w_blocks = (mask.shape[1] + 1) // 2
        block = (ys // 2) * w_blocks + xs // 2
        first = np.full(n_fg + 1, np.iinfo(np.int64).max)
        np.minimum.at(first, labels[ys, xs], block)
        order = np.argsort(first[1:], kind="stable") + 1
        remap = np.zeros(n_fg + 1, np.int32)
        remap[order] = np.arange(1, n_fg + 1, dtype=np.int32)
        labels = remap[labels]
    labels = labels.astype(np.int32)
    areas = np.bincount(labels.reshape(-1), minlength=n_fg + 1)
    return n_fg + 1, labels, areas.astype(np.int64)


def distance_l1(mask) -> np.ndarray:
    """cv2.distanceTransform(mask, DIST_L1, 5) as float32: each nonzero
    cell's L1 (taxicab) distance to the nearest zero cell."""
    mask = np.asarray(mask, bool)
    return ndimage.distance_transform_cdt(mask, metric="taxicab").astype(
        np.float32)


# -- drawing (OpenCV drawing.cpp, LINE_8) -----------------------------------

def _line_points(x0, y0, x1, y1):
    """Pixels of cv2's 8-connected Bresenham line between integer points
    (LineIterator, left to right)."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    pts = []
    for _ in range(major + 1):
        pts.append((x, y))
        diag = err < 0
        err += -2 * minor + (2 * major if diag else 0)
        if steep:
            y += sy
            if diag:
                x += 1
        else:
            x += 1
            if diag:
                y += sy
    return pts


def draw_lines(shape, p0, p1) -> np.ndarray:
    """cv2.line(canvas, p0[i], p1[i], 1, 1) for every i on one zero (H, W)
    uint8 canvas, LINE_8: the cells of cv2's 8-connected LineIterator
    (left to right), ends outside the grid clipped as cv2.clipLine clips
    them.  p0, p1 (N, 2) integer (x, y) points, or one point broadcast
    against the other's N.  Vectorized over the lines: the k-th cell of
    a line with major extent M and minor extent m steps the minor axis
    ceil((2 m k - M) / (2 M)) times, Bresenham's error term in closed
    form."""
    h, w = shape
    p0 = np.asarray(p0, np.int64).reshape(-1, 2)
    p1 = np.asarray(p1, np.int64).reshape(-1, 2)
    p0, p1 = np.broadcast_arrays(p0, p1)
    x0, y0 = p0[:, 0].copy(), p0[:, 1].copy()
    x1, y1 = p1[:, 0].copy(), p1[:, 1].copy()
    out = np.zeros((h, w), np.uint8)
    keep = np.ones(len(x0), bool)
    outside = ((x0 < 0) | (x0 >= w) | (y0 < 0) | (y0 >= h)
               | (x1 < 0) | (x1 >= w) | (y1 < 0) | (y1 >= h))
    for i in np.nonzero(outside)[0]:
        keep[i], x0[i], y0[i], x1[i], y1[i] = _clip_ends(
            w, h, int(x0[i]), int(y0[i]), int(x1[i]), int(y1[i]))
    x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
    swap = x1 < x0
    x0, x1 = np.where(swap, x1, x0), np.where(swap, x0, x1)
    y0, y1 = np.where(swap, y1, y0), np.where(swap, y0, y1)
    dx, dy = x1 - x0, y1 - y0
    sy = np.where(dy < 0, -1, 1)
    steep = np.abs(dy) > dx
    major = np.where(steep, np.abs(dy), dx)
    minor = np.where(steep, dx, np.abs(dy))
    count = major + 1
    line = np.repeat(np.arange(len(x0)), count)
    k = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count,
                                                 count)
    big, small = major[line], minor[line]
    n_minor = -((big - 2 * small * k) // np.maximum(2 * big, 1))
    st = steep[line]
    xs = x0[line] + np.where(st, n_minor, k)
    ys = y0[line] + sy[line] * np.where(st, k, n_minor)
    out[ys, xs] = 1
    return out


def _clip_ends(w: int, h: int, x1, y1, x2, y2):
    """cv2.clipLine: (inside, x1, y1, x2, y2), the ends as cv2 leaves
    them, also when nothing of the segment is inside."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line2_points(p1, p2, shape):
    """Pixels of cv2's Line2: an 8-connected line between 16.16
    fixed-point points, clipped to the (H, W) grid first."""
    inside, x1, y1, x2, y2 = _clip_ends(shape[1] << _XY_SHIFT,
                                        shape[0] << _XY_SHIFT,
                                        p1[0], p1[1], p2[0], p2[1])
    if not inside:
        return []
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        x_step = _XY_ONE
        y_step = _cdiv(dy * _XY_ONE, ax | 1)
        ecount = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        x_step = _cdiv(dx * _XY_ONE, ay | 1)
        y_step = _XY_ONE
        ecount = (y2 - y1) >> _XY_SHIFT
    x1 += _XY_ONE >> 1
    y1 += _XY_ONE >> 1
    pts = [((x2 + (_XY_ONE >> 1)) >> _XY_SHIFT,
            (y2 + (_XY_ONE >> 1)) >> _XY_SHIFT)]
    if ax > ay:
        x1 >>= _XY_SHIFT
        while ecount >= 0:
            pts.append((x1, y1 >> _XY_SHIFT))
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= _XY_SHIFT
        while ecount >= 0:
            pts.append((x1 >> _XY_SHIFT, y1))
            x1 += x_step
            y1 += 1
            ecount -= 1
    return pts


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _circle_spans(cx, cy, r):
    """Rows (y, x1, x2) of cv2's filled Circle (midpoint algorithm)."""
    spans = []
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        spans += [(cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                  (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)]
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return spans


def _convex_poly(v, shape):
    """Pixels (spans and points) of cv2's FillConvexPoly over 16.16
    fixed-point vertices v (list of (x, y)) on an (H, W) grid, LINE_8."""
    spans, pts = [], []
    npts = len(v)
    delta = 1 << _XY_SHIFT >> 1
    p0 = v[-1]
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        pts += _line2_points(p0, p, shape)
        p0 = p
    ymin = (ymin + delta) >> _XY_SHIFT
    ymax = (ymax + delta) >> _XY_SHIFT
    edge_idx, edge_di = [imin, imin], [1, npts - 1]
    edge_x, edge_dx, edge_ye = [-_XY_ONE, -_XY_ONE], [0, 0], [ymin, ymin]
    edges = npts
    y = ymin
    while True:
        for i in range(2):
            if y >= edge_ye[i]:
                idx0, di = edge_idx[i], edge_di[i]
                idx = (idx0 + di) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> _XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        edge_ye[i] = ty
                        edge_dx[i] = _cdiv((xe - xs) * 2 + (ty - y),
                                           2 * (ty - y))
                        edge_x[i] = xs
                        edge_idx[i] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
        if edges < 0:
            break
        left, right = (1, 0) if edge_x[0] > edge_x[1] else (0, 1)
        x1 = (edge_x[left] + delta) >> _XY_SHIFT
        x2 = (edge_x[right] + delta) >> _XY_SHIFT
        spans.append((y, x1, x2))
        edge_x[0] += edge_dx[0]
        edge_x[1] += edge_dx[1]
        y += 1
        if y > ymax:
            break
    return spans, pts


def _thick_line_pixels(p0, p1, thickness: int, shape):
    """Spans and points of cv2.line(p0, p1, thickness) for thickness > 1:
    the body as a fixed-point convex quad, a filled circle at each end."""
    (x0, y0), (x1, y1) = ((int(p[0]) << _XY_SHIFT, int(p[1]) << _XY_SHIFT)
                          for p in (p0, p1))
    dx = (x0 - x1) / _XY_ONE
    dy = (y1 - y0) / _XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (_XY_SHIFT - 1)
    spans, pts = [], []
    if abs(r) > np.finfo(np.float64).eps:
        r = (th + odd * _XY_ONE * 0.5) / math.sqrt(r)
        dpx = int(np.rint(dy * r))
        dpy = int(np.rint(dx * r))
        quad = [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)]
        spans, pts = _convex_poly(quad, shape)
    rad = (th + (_XY_ONE >> 1)) >> _XY_SHIFT
    for px, py in ((x0, y0), (x1, y1)):
        spans += _circle_spans((px + (_XY_ONE >> 1)) >> _XY_SHIFT,
                               (py + (_XY_ONE >> 1)) >> _XY_SHIFT, rad)
    return spans, pts


def fill_circle(shape, center, radius: int) -> np.ndarray:
    """cv2.circle(np.zeros(shape, uint8), center, radius, 1, -1) as a
    uint8 grid."""
    return _paint(shape, _circle_spans(int(center[0]), int(center[1]),
                                       int(radius)), [])


def _paint(shape, spans, pts, origin=(0, 0)) -> np.ndarray:
    """(H, W) uint8 grid with the spans (y, x1, x2) and points (x, y)
    set, clipped to the grid; coordinates are offset by origin (x, y)."""
    h, w = shape
    out = np.zeros((h, w), np.uint8)
    ox, oy = origin
    for y, x1, x2 in spans:
        y -= oy
        if 0 <= y < h:
            a, b = max(x1 - ox, 0), min(x2 - ox, w - 1)
            if a <= b:
                out[y, a:b + 1] = 1
    for x, y in pts:
        x, y = x - ox, y - oy
        if 0 <= x < w and 0 <= y < h:
            out[y, x] = 1
    return out


def thick_line_box(p0, p1, thickness: int, shape):
    """cv2.line(np.zeros(shape, uint8), p0, p1, 1, thickness), LINE_8,
    thickness > 1, within the cells' bounding box clipped to the grid:
    (mask, y0, x0) with mask (h, w) uint8 over rows y0.. and columns x0..
    of the grid (a short line on a large grid touches few cells)."""
    spans, pts = _thick_line_pixels(p0, p1, int(thickness), shape)
    ys = [s[0] for s in spans] + [p[1] for p in pts]
    xs = [s[1] for s in spans] + [s[2] for s in spans] + [p[0] for p in pts]
    y0, y1 = max(min(ys), 0), min(max(ys), shape[0] - 1)
    x0, x1 = max(min(xs), 0), min(max(xs), shape[1] - 1)
    if y1 < y0 or x1 < x0:
        return np.zeros((0, 0), np.uint8), 0, 0
    return _paint((y1 - y0 + 1, x1 - x0 + 1), spans, pts, (x0, y0)), y0, x0


def fill_poly(shape, points) -> np.ndarray:
    """cv2.fillPoly(np.zeros(shape, uint8), [points], 1), LINE_8, one
    contour of integer (x, y) points, as a uint8 grid: the outline's
    Bresenham lines plus the edge-list scanline fill, cell for cell, the
    grid's border included.

    An edge that leaves the grid is clipped (cv2.clipLine).  Its outline
    is the clipped segment's line; its scanline edge follows the clipped
    segment over the rows of that segment, its end row included, and on
    the edge's other rows stands just outside the grid (x = -1 or x = W),
    on the side of the clipped end next to them."""
    h, w = shape
    v = [(int(p[0]), int(p[1])) for p in np.asarray(points).reshape(-1, 2)]
    pts, edges = [], []

    def add(y0, y1, a, b):
        """An edge over rows [y0, y1) on the line through a and b."""
        if y0 < y1:
            dx = ((b[0] - a[0]) << _XY_SHIFT) // (b[1] - a[1])
            edges.append((y0, y1, (a[0] << _XY_SHIFT) + (y0 - a[1]) * dx,
                          dx))

    def outside(y0, y1, end):
        """A vertical edge over rows [y0, y1) just outside the grid, on
        the side of the clipped end `end`."""
        if y0 < y1:
            edges.append((y0, y1, (-1 if end[0] <= 0 else w) << _XY_SHIFT,
                          0))

    p0 = v[-1]
    for p1 in v:
        lo, hi = (p0, p1) if p0[1] < p1[1] else (p1, p0)
        if (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h
                and 0 <= p1[1] < h):
            pts += _line_points(*p0, *p1)
            add(lo[1], hi[1], lo, hi)
        else:
            ok, x0, y0, x1, y1 = _clip_ends(w, h, *p0, *p1)
            if ok:
                pts += _line_points(x0, y0, x1, y1)
            if y0 == y1:
                # the clipped ends' x at the edge's own rows
                a, b = ((x0, p0[1]), (x1, p1[1])) if p0[1] < p1[1] \
                    else ((x1, p1[1]), (x0, p0[1]))
                add(lo[1], hi[1], a, b)
            else:
                a, b = ((x0, y0), (x1, y1)) if y0 < y1 else ((x1, y1),
                                                             (x0, y0))
                if ok:
                    ya, yb = max(lo[1], a[1]), min(hi[1], b[1] + 1)
                    add(ya, yb, a, b)
                    outside(lo[1], ya, a)
                    outside(yb, hi[1], b)
                else:
                    add(lo[1], hi[1], a, b)
        p0 = p1
    spans = []
    half = _XY_ONE >> 1
    if len(edges) >= 2:
        y_lo = min(e[0] for e in edges)
        for y in range(max(y_lo, 0), min(max(e[1] for e in edges), h)):
            xs = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges
                        if y0 <= y < y1)
            for a, b in zip(xs[0::2], xs[1::2]):
                spans.append((y, (a + half) >> _XY_SHIFT,
                              (b + half - 1) >> _XY_SHIFT))
    return _paint(shape, spans, pts)


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB image as an 8-bit RGB PNG (zlib level 6, no
    filter): the pixels cv2.imwrite(path, img[..., ::-1]) stores."""
    import struct
    import zlib
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + row.tobytes() for row in img)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
