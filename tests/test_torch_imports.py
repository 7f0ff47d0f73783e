"""The PyTorch port and chip_smoke.py must not import JAX (nor flax or
optax) or anything of the JAX package (not even its JAX-free modules),
nor OpenCV (cv2), PIL or matplotlib: the port runs on a machine without
JAX and without them (utils/raster.py has the port's own form of each
cv2 call and its PNG reader and writer).  The optional packages of a
few paths (habitat, habitat_sim, open3d, trimesh) are imported only by
the module that gates them, inside the function that needs them."""
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "fisher_nerf_customized_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|cv2\b|flax\b|optax\b"
    r"|PIL\b|matplotlib\b|fisher_nerf_customized_tpu\b(?!_torch))",
    re.MULTILINE)
# each optional package and the one module that may import it (indented:
# inside a function, never at import time)
OPTIONAL = {"habitat": "envs/habitat_adapter.py",
            "habitat_sim": "envs/habitat_adapter.py",
            "open3d": "tools/extract_3d_model.py",
            "trimesh": "tools/evaluation.py"}
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
# the habitat adapter, perceptual networks and evaluation tools slice's
HABITAT_TOOLS_MODULES = [
    "envs/habitat_adapter.py", "models/perceptual.py", "utils/precision.py",
    "tools/eval_render.py", "tools/eval_3d_reconstruction.py",
    "tools/evaluation.py", "tools/auc_evaluation.py",
    "tools/extract_3d_model.py", "tools/quality_check.py",
    "tools/render_profile.py", "tools/capacity_probe.py"]


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
               + KNOWN_ENV_MODULES + UPEN_MODULES + PLANNING_API_MODULES
               + HABITAT_TOOLS_MODULES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_packages_stay_gated(path):
    text = path.read_text()
    rel = str(path.relative_to(ROOT / "fisher_nerf_customized_tpu_torch")) \
        if path.name != "chip_smoke.py" else "chip_smoke.py"
    for name, owner in OPTIONAL.items():
        hits = re.findall(rf"^(\s*)(?:import|from)\s+{name}\b", text,
                          re.MULTILINE)
        if rel != owner:
            assert not hits, f"{rel} imports {name}"
        else:
            assert hits and all(indent for indent in hits), \
                f"{rel} imports {name} at module level"


def test_forbidden_pattern_catches_jax_imports():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "from fisher_nerf_customized_tpu.ops import fisher",
           "import fisher_nerf_customized_tpu",
           "    from fisher_nerf_customized_tpu.config import node",
           "import cv2", "    import cv2  # noqa", "from cv2 import line",
           "from PIL import Image", "import matplotlib.pyplot as plt",
           "import flax.linen as nn", "from flax.core import FrozenDict",
           "import optax"]
    good = ["import torch", "from fisher_nerf_customized_tpu_torch.ops "
            "import fisher", "from .ops import binning",
            "from ..utils.raster import fill_poly", "import cv2x",
            "import flaxen"]
    assert all(FORBIDDEN.search(s) for s in bad)
    assert not any(FORBIDDEN.search(s) for s in good)
