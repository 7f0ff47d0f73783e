"""A Gaussian checkpoint as 3D models (the JAX package's
scripts/extract_3d_model.py, the same files): <prefix>_points.ply, the
colored means of the Gaussians with opacity >= --opacity_thresh, and
<prefix>_voxmesh.ply, the boundary faces of their occupied --voxel cells
as a triangle mesh; with --poisson, open3d's Poisson mesh instead
(<prefix>_poisson.ply), when open3d is installed.

    python -m fisher_nerf_customized_tpu_torch.tools.extract_3d_model \\
        RUN/params<t>.npz [--out_prefix P] [--opacity_thresh 0.3] \\
        [--voxel 0.05] [--poisson]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.pointcloud import write_ply

# each face of a unit voxel: the neighbour it faces and its 4 corners
_FACES = (
    ((1, 0, 0), [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)]),
    ((-1, 0, 0), [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)]),
    ((0, 1, 0), [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)]),
    ((0, -1, 0), [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)]),
    ((0, 0, 1), [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]),
    ((0, 0, -1), [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)]),
)


def voxel_cube_mesh(points, voxel: float = 0.05):
    """The occupied voxels' boundary faces, two triangles each:
    (verts (V, 3) float32, faces (F, 3) int32)."""
    vox = np.unique(np.floor(points / voxel).astype(np.int64), axis=0)
    occupied = set(map(tuple, vox))
    verts, faces = [], []
    for v in map(tuple, vox):
        for normal, corners in _FACES:
            nb = (v[0] + normal[0], v[1] + normal[1], v[2] + normal[2])
            if nb in occupied:
                continue
            base = len(verts)
            for c in corners:
                verts.append(((v[0] + c[0]) * voxel, (v[1] + c[1]) * voxel,
                              (v[2] + c[2]) * voxel))
            faces.append((base, base + 1, base + 2))
            faces.append((base, base + 2, base + 3))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def write_mesh_ply(path, verts, faces):
    """A binary little-endian PLY triangle mesh."""
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {len(verts)}",
                  "property float x", "property float y", "property float z",
                  f"element face {len(faces)}",
                  "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        f.write(np.asarray(verts, "<f4").tobytes())
        rec = np.zeros(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
        rec["n"] = 3
        rec["v"] = faces
        f.write(rec.tobytes())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("params_npz")
    p.add_argument("--out_prefix", default=None)
    p.add_argument("--opacity_thresh", type=float, default=0.3)
    p.add_argument("--voxel", type=float, default=0.05)
    p.add_argument("--poisson", action="store_true")
    args = p.parse_args(argv)

    data = np.load(args.params_npz)
    n = int(data["n_active"]) if "n_active" in data else len(data["means3D"])
    means = data["means3D"][:n]
    colors = data["rgb_colors"][:n]
    opac = 1.0 / (1.0 + np.exp(-data["logit_opacities"][:n, 0]))
    keep = opac >= args.opacity_thresh
    means, colors = means[keep], colors[keep]

    prefix = args.out_prefix or os.path.splitext(args.params_npz)[0]
    write_ply(prefix + "_points.ply", means, colors)
    print(f"wrote {prefix}_points.ply ({len(means)} pts)")

    if args.poisson:
        try:
            import open3d as o3d
            pcd = o3d.geometry.PointCloud()
            pcd.points = o3d.utility.Vector3dVector(means)
            pcd.estimate_normals()
            mesh, _ = \
                o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(pcd)
            o3d.io.write_triangle_mesh(prefix + "_poisson.ply", mesh)
            print(f"wrote {prefix}_poisson.ply")
            return
        except ImportError:
            print("open3d unavailable; falling back to voxel mesh")
    verts, faces = voxel_cube_mesh(means, args.voxel)
    write_mesh_ply(prefix + "_voxmesh.ply", verts, faces)
    print(f"wrote {prefix}_voxmesh.ply ({len(faces)} tris)")


if __name__ == "__main__":
    main()
