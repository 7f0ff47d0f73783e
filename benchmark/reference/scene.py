"""The FakeSim box scene's ground truth, worked out again: a per-pixel
nearest-hit ray/box raycast of the scene's boxes (the room shell seen
from inside, the obstacles from outside) with the procedural checker and
stripe colours, in plain PyTorch.  The boxes are the scene's data, handed
to the program and to this reference alike."""
from __future__ import annotations

import torch


def raycast(lo, hi, inward, seeds, c2w, fx, fy, cx, cy, width, height):
    """rgb (P, H, W, 3) and z-depth (P, H, W) at c2w (P, 4, 4); lo, hi
    (B, 3), inward (B,) bool, seeds (B,) float.  The pixel offsets are
    scaled by the f32 reciprocal of the focal length, the hit point is
    taken in float64, as the program's own raycast does, so that a face on
    the 0.5 m grid gets the same side of its checker."""
    dev, f32 = lo.device, torch.float32
    ys = (torch.arange(height, dtype=f32, device=dev) - cy) \
        * torch.tensor(1.0 / fy, dtype=f32)
    xs = (torch.arange(width, dtype=f32, device=dev) - cx) \
        * torch.tensor(1.0 / fx, dtype=f32)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    rot = c2w[:, None, None, :3, :3]
    dirs = (gx[..., None] * rot[..., 0] + gy[..., None] * rot[..., 1]) \
        + rot[..., 2]
    origin = c2w[:, None, None, :3, 3]
    inv_d = 1.0 / torch.where(torch.abs(dirs) < 1e-9,
                              torch.full_like(dirs, 1e-9), dirs)
    box = (slice(None), None, None, None)
    t0 = (lo[box] - origin) * inv_d[None]
    t1 = (hi[box] - origin) * inv_d[None]
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    t_hit = torch.where(inward[box], tmax, tmin)
    ok = (tmax >= torch.clamp(tmin, min=0.0)) & (t_hit > 1e-4)
    t_hit = torch.where(ok, t_hit, torch.full_like(t_hit, float("inf")))
    best = torch.argmin(t_hit, dim=0)
    t_best = t_hit.amin(dim=0)
    t_best = torch.where(torch.isfinite(t_best), t_best,
                         torch.zeros_like(t_best))
    p = (origin.double() + dirs.double() * t_best[..., None].double()).float()
    seed = seeds[best]
    checker = torch.remainder(torch.floor(p[..., 0] / 0.5)
                              + torch.floor(p[..., 1] / 0.5)
                              + torch.floor(p[..., 2] / 0.5), 2.0)
    shade = 0.75 + 0.25 * checker
    stripes = 0.85 + 0.15 * torch.sin(p[..., 0] * 7.0) * torch.sin(
        p[..., 2] * 7.0)
    rgb = torch.stack([
        (0.25 + 0.5 * torch.abs(torch.sin(seed * 2.1 + 1.0))) * shade
        * stripes,
        (0.25 + 0.5 * torch.abs(torch.sin(seed * 3.7 + 2.0))) * shade,
        (0.25 + 0.5 * torch.abs(torch.sin(seed * 5.3 + 3.0)))
        * (1.25 - 0.25 * checker)], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0), t_best
