"""Candidate camera-pose sampling for EIG evaluation (host-side numpy).

A ring of K poses around xz center points, each looking back at its
center (the reference's generate_candidate: theta+pi yaw, then the x/y
column flips of the CV camera frame); uniform poses over the eroded free
space when no frontier is left; random Gaussians above frontier cells.
Each function draws from the caller's numpy generator in the JAX
package's order, so one seed gives both packages the same poses.
"""
from __future__ import annotations

import numpy as np

from ..utils.raster import erode_square


def _yaw_rotmat(theta):
    """y-axis rotation (world y-up) for an array of angles: (K, 3, 3)."""
    c, s = np.cos(theta), np.sin(theta)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, zeros, s], -1),
        np.stack([zeros, ones, zeros], -1),
        np.stack([-s, zeros, c], -1),
    ], axis=-2)


def generate_candidates(center_points: np.ndarray, k: int, radius: float,
                        min_range: float, cam_height: float,
                        rng: np.random.Generator,
                        expansion: float = 1.0) -> np.ndarray:
    """K c2w poses (K, 4, 4) on rings around the given (M, 2) xz centers."""
    radius = radius * expansion
    theta = rng.uniform(0.0, 2 * np.pi, k)
    rr = min_range + rng.uniform(0.0, 1.0, k) * max(radius - min_range, 1e-6)
    centers = center_points[rng.integers(0, len(center_points), k)]

    pos = np.zeros((k, 3), np.float32)
    pos[:, 0] = centers[:, 0] + rr * np.sin(theta)
    pos[:, 1] = cam_height
    pos[:, 2] = centers[:, 1] + rr * np.cos(theta)

    R = _yaw_rotmat(theta + np.pi)
    R[:, :, 0] *= -1.0      # CV camera: x right (flip), y down (flip)
    R[:, :, 1] *= -1.0

    c2ws = np.zeros((k, 4, 4), np.float32)
    c2ws[:, :3, :3] = R
    c2ws[:, :3, 3] = pos
    c2ws[:, 3, 3] = 1.0
    return c2ws


def generate_candidates_object(anchor_points: np.ndarray, k: int,
                               radius: float, min_range: float,
                               cam_height: float, rng: np.random.Generator,
                               expansion: float = 1.0,
                               theta_step_deg: float = 15.0,
                               radial_bins: int = 6,
                               radial_spacing: str = "linear") -> np.ndarray:
    """K c2w poses (K, 4, 4) around an object: a sorted grid of angles
    (theta_step_deg apart) times radial rings, cycled over K anchors drawn
    with replacement from the object's footprint cells (M, 2) xz; each
    pose looks back at its anchor (the reference's
    generate_candidate_adv_object, mode 'sorted')."""
    radius = radius * expansion
    anchors = anchor_points[rng.integers(0, len(anchor_points), k)]
    n_theta = max(1, int(round(360.0 / theta_step_deg)))
    thetas = np.linspace(0.0, 2 * np.pi, n_theta, endpoint=False)
    radial_bins = max(1, int(radial_bins))
    if radial_spacing == "sqrt_area" and radial_bins > 1:
        u = np.linspace(0.0, 1.0, radial_bins)
        r_vals = np.sqrt(min_range ** 2 + u * (radius ** 2 - min_range ** 2))
    else:
        r_vals = np.linspace(min_range, max(radius, min_range), radial_bins)
    grid_t, grid_r = np.meshgrid(thetas, r_vals, indexing="ij")
    grid = np.stack([grid_t.ravel(), grid_r.ravel()], -1)   # (T*B, 2)
    sel = np.arange(k) % len(grid)
    theta, rr = grid[sel, 0], grid[sel, 1]

    pos = np.zeros((k, 3), np.float32)
    pos[:, 0] = anchors[:, 0] + rr * np.sin(theta)
    pos[:, 1] = cam_height
    pos[:, 2] = anchors[:, 1] + rr * np.cos(theta)
    R = _yaw_rotmat(theta + np.pi)
    R[:, :, 0] *= -1.0
    R[:, :, 1] *= -1.0
    c2ws = np.zeros((k, 4, 4), np.float32)
    c2ws[:, :3, :3] = R
    c2ws[:, :3, 3] = pos
    c2ws[:, 3, 3] = 1.0
    return c2ws


def sample_random_candidates(agent_pos: np.ndarray, free_space: np.ndarray,
                             grid_dim, cell_size: float, map_center,
                             rng: np.random.Generator,
                             erode_iter: int = 11) -> np.ndarray:
    """Uniform random poses over the eroded free space (the reference's
    sample_random_candidate: erode 11x11, keep 1/4 of the cells, random
    yaw)."""
    eroded = erode_square(free_space, erode_iter)
    mz, mx = np.where(eroded == 1)
    if len(mz) == 0:
        return np.zeros((0, 4, 4), np.float32)
    wz = (mz + 0.5 - grid_dim[1] // 2) * cell_size + map_center[1]
    wx = (mx + 0.5 - grid_dim[0] // 2) * cell_size + map_center[0]
    sel = rng.choice(len(wz), max(len(wz) // 4, 1))
    wx, wz = wx[sel], wz[sel]

    theta = rng.uniform(0.0, 2 * np.pi, len(wx))
    R = _yaw_rotmat(theta)
    poses = np.zeros((len(wx), 4, 4), np.float32)
    poses[:, :3, :3] = R
    poses[:, :3, 3] = np.stack(
        [wx, np.full_like(wx, agent_pos[1]), wz], -1)
    poses[:, 3, 3] = 1.0
    # the CV-frame axis flips of the reference (random_pose[:, :, 1|2] *= -1)
    poses[:, :, 1] *= -1.0
    poses[:, :, 2] *= -1.0
    poses[:, 3, 3] = 1.0
    return poses


def generate_random_gaussians(candidate_pos: np.ndarray, cell_size: float,
                              cam_height: float, rng: np.random.Generator,
                              per_cell: int = 200) -> dict | None:
    """Random Gaussians above frontier cells: uncertainty mass that makes
    unexplored regions attractive to the EIG (the reference's
    generate_random_gaussians)."""
    if candidate_pos is None or len(candidate_pos) == 0:
        return None
    n_cells = candidate_pos.shape[0]
    xz_off = rng.uniform(0, cell_size, (1, per_cell, 2))
    y_off = (cam_height - 1.0) + rng.uniform(0, 1.0, (n_cells, per_cell, 1))
    xz = candidate_pos[:, None, :] + xz_off
    pts = np.concatenate([xz, y_off], axis=-1).reshape(-1, 3)
    pts = pts[:, [0, 2, 1]]                       # to x-y-z order
    m = pts.shape[0]
    rots = np.zeros((m, 4), np.float32)
    rots[:, 0] = 1.0
    return dict(
        means3D=pts.astype(np.float32),
        scales=(rng.uniform(0, 1, (m, 3)).clip(min=1e-3)
                * cell_size * 0.05).astype(np.float32),
        rotations=rots,
        opacity=rng.uniform(0, 1, (m, 1)).clip(min=1e-3).astype(np.float32),
        shs=rng.uniform(0, 1, (m, 1, 3)).astype(np.float32),
    )
