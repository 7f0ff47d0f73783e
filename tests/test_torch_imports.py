"""The PyTorch port and chip_smoke.py must not import JAX (nor flax or
optax) or anything of the JAX package (not even its JAX-free modules),
nor OpenCV (cv2): the port runs on a machine without JAX and without cv2
(utils/raster.py has the port's own form of each cv2 call)."""
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "fisher_nerf_customized_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|cv2\b|flax\b|optax\b"
    r"|fisher_nerf_customized_tpu\b(?!_torch))", re.MULTILINE)
# the episode slice's modules: they must exist (test_no_jax_imports checks
# them with every other file of the port)
EPISODE_MODULES = [
    "utils/raster.py", "utils/logging_utils.py", "planning/occupancy.py",
    "planning/astar.py", "planning/sweep.py", "planning/candidates.py",
    "planning/planner.py", "engine/actions.py", "engine/path_eval.py",
    "engine/visualization.py", "engine/driver.py", "cli.py", "__main__.py"]
# the evaluation and checkpoint slice's modules
EVAL_MODULES = [
    "engine/eval.py", "utils/pointcloud.py", "utils/io.py",
    "tools/multi_scene_sweep.py"]
# the object branch's modules
OBJECT_MODULES = [
    "models/object_slam.py", "engine/object_planning.py",
    "engine/seg_metrics.py", "ops/fisher.py", "ops/cuda_blend_bwd.py",
    "envs/fake_sim.py"]
# the known-environment and navigation slice's modules
KNOWN_ENV_MODULES = [
    "ops/knn.py", "ops/cuda_knn.py", "engine/navigator.py",
    "main_navigation.py", "planning/astar.py"]
# the UPEN, DINO gate and navigation images slice's modules
UPEN_MODULES = [
    "planning/rrt.py", "planning/frontier_search.py", "models/networks.py",
    "models/predictors.py", "models/semantic_grid.py", "models/upen.py",
    "engine/dino_gate.py", "engine/visualization.py",
    "envs/offline_dataset.py", "tools/train_predictors.py"]
# the pipelined planning, legacy planning API and SH slice's modules
PLANNING_API_MODULES = [
    "utils/clustering.py", "models/droid_wrapper.py", "planning/occ_map.py",
    "planning/ddppo_net.py", "planning/local_policy.py", "ops/sh.py",
    "ops/naive.py"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    text = path.read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path.name} imports {hits}"
    assert "importlib" not in text or "jax" not in text
    assert "importlib" not in text or "cv2" not in text


def test_episode_modules_are_checked():
    port = ROOT / "fisher_nerf_customized_tpu_torch"
    assert all(port / m in FILES
               for m in EPISODE_MODULES + EVAL_MODULES + OBJECT_MODULES
               + KNOWN_ENV_MODULES + UPEN_MODULES + PLANNING_API_MODULES)


def test_forbidden_pattern_catches_jax_imports():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "from fisher_nerf_customized_tpu.ops import fisher",
           "import fisher_nerf_customized_tpu",
           "    from fisher_nerf_customized_tpu.config import node",
           "import cv2", "    import cv2  # noqa", "from cv2 import line",
           "import flax.linen as nn", "from flax.core import FrozenDict",
           "import optax"]
    good = ["import torch", "from fisher_nerf_customized_tpu_torch.ops "
            "import fisher", "from .ops import binning",
            "from ..utils.raster import fill_poly", "import cv2x",
            "import flaxen"]
    assert all(FORBIDDEN.search(s) for s in bad)
    assert not any(FORBIDDEN.search(s) for s in good)
