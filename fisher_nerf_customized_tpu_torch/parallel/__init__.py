"""Scale-out over a torch.distributed process group: the mesh
(mesh.py), the group (distributed.py) and the sharded paths
(sharding.py).  Imports torch and numpy only."""
from .mesh import make_mesh
from .sharding import (pose_eval_sharded, mapping_step_sharded,
                       multi_scene_occ_update, render_gaussian_sharded,
                       fisher_diag_gaussian_sharded)

__all__ = ["make_mesh", "pose_eval_sharded", "mapping_step_sharded",
           "multi_scene_occ_update", "render_gaussian_sharded",
           "fisher_diag_gaussian_sharded"]
