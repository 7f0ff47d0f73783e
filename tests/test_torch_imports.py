"""The PyTorch port and chip_smoke.py must not import JAX (nor flax or
optax) or anything of the JAX package (not even its JAX-free modules),
nor OpenCV (cv2), PIL, matplotlib, imageio or PyAV (av), nor run
ffmpeg: the port runs on a machine without JAX and without them
(utils/raster.py has the port's own form of each cv2 call and its PNG
reader and writer, utils/video.py its mp4 writer).  The optional packages of a
few paths (habitat, habitat_sim, open3d, trimesh, wandb) are imported
only by the module that gates them, inside the function that needs them.

Each subpackage imports first in a fresh interpreter (no import cycle),
exports the JAX package's `__all__` name for name, imports no JAX and
builds no kernel."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "fisher_nerf_customized_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|cv2\b|flax\b|optax\b"
    r"|PIL\b|matplotlib\b|imageio\b|av\b"
    r"|fisher_nerf_customized_tpu\b(?!_torch))",
    re.MULTILINE)
# each optional package and the one module that may import it (indented:
# inside a function, never at import time)
OPTIONAL = {"habitat": "envs/habitat_adapter.py",
            "habitat_sim": "envs/habitat_adapter.py",
            "open3d": "tools/extract_3d_model.py",
            "trimesh": "tools/evaluation.py",
            "wandb": "utils/logging_utils.py"}
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

# the scale-out slice's modules (torch.distributed)
PARALLEL_MODULES = [
    "parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
    "parallel/sharding.py", "parallel/launch.py"]
# the trajectory video's modules
VIDEO_MODULES = ["utils/video.py", "engine/visualization.py"]
# a program named in a string: how a subprocess would run ffmpeg
FFMPEG_CALL = re.compile(r"[\"']ffmpeg(?:\.exe)?[\"']", re.IGNORECASE)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    text = path.read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path.name} imports {hits}"
    assert "importlib" not in text or "jax" not in text
    assert "importlib" not in text or "cv2" not in text
    assert not FFMPEG_CALL.search(text), f"{path.name} names ffmpeg"


def test_episode_modules_are_checked():
    port = ROOT / "fisher_nerf_customized_tpu_torch"
    assert all(port / m in FILES
               for m in EPISODE_MODULES + EVAL_MODULES + OBJECT_MODULES
               + KNOWN_ENV_MODULES + UPEN_MODULES + PLANNING_API_MODULES
               + HABITAT_TOOLS_MODULES + PARALLEL_MODULES + VIDEO_MODULES)


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


def test_video_encoder_imports_numpy_and_the_standard_library():
    """utils/video.py writes the mp4 with numpy and struct alone."""
    tree = ast.parse((ROOT / "fisher_nerf_customized_tpu_torch" / "utils"
                      / "video.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names == {"__future__", "numpy", "struct"}
    assert not any(isinstance(n, ast.ImportFrom) and n.level
                   for n in ast.walk(tree))
    assert FFMPEG_CALL.search("subprocess.run(['ffmpeg', '-i'])")
    assert not FFMPEG_CALL.search("FFmpeg's decoder")


def test_forbidden_pattern_catches_jax_imports():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "from fisher_nerf_customized_tpu.ops import fisher",
           "import fisher_nerf_customized_tpu",
           "    from fisher_nerf_customized_tpu.config import node",
           "import cv2", "    import cv2  # noqa", "from cv2 import line",
           "from PIL import Image", "import matplotlib.pyplot as plt",
           "import flax.linen as nn", "from flax.core import FrozenDict",
           "import optax", "import imageio", "import imageio.v3 as iio",
           "import av", "from av import open"]
    good = ["import torch", "from fisher_nerf_customized_tpu_torch.ops "
            "import fisher", "from .ops import binning",
            "from ..utils.raster import fill_poly", "import cv2x",
            "import flaxen", "import avro", "import average"]
    assert all(FORBIDDEN.search(s) for s in bad)
    assert not any(FORBIDDEN.search(s) for s in good)


SUBPACKAGES = ["", "config", "ops", "planning", "engine", "envs", "models",
               "parallel", "utils", "tools"]


def _jax_all(sub: str) -> list:
    """The JAX package's __all__ of a subpackage, read from its source
    (the JAX package is not imported); none where it has no such
    subpackage (tools/)."""
    path = ROOT / "fisher_nerf_customized_tpu" / sub / "__init__.py"
    if not path.exists():
        return []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return []


def _build_dir_state():
    build = ROOT / "fisher_nerf_customized_tpu_torch" / "_build"
    return sorted((str(p), p.stat().st_mtime_ns) for p in build.rglob("*")) \
        if build.exists() else None


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_subpackage_imports_first_and_exports(sub):
    names = _jax_all(sub)
    mod = "fisher_nerf_customized_tpu_torch" + (f".{sub}" if sub else "")
    before = _build_dir_state()
    code = "\n".join([
        "import sys",
        # any import of JAX, cv2 or the JAX package fails
        "for name in ('jax', 'jaxlib', 'cv2', 'fisher_nerf_customized_tpu'):",
        "    sys.modules[name] = None",
        f"import {mod} as m",
        f"assert list(getattr(m, '__all__', [])) == {names!r}, m.__all__",
        f"from {mod} import {', '.join(names) or '__name__'}",
        "print(getattr(m, '__version__', ''))"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    if not sub:
        assert out.stdout.strip() == "0.1.0"
    assert _build_dir_state() == before


def test_jax_exports_are_listed():
    """The JAX package's subpackages that export names are the ones
    checked above."""
    exporting = sorted(p.parent.name for p in
                       (ROOT / "fisher_nerf_customized_tpu").glob(
                           "*/__init__.py") if _jax_all(p.parent.name))
    assert exporting == ["config", "engine", "envs", "models", "ops",
                         "parallel", "planning"]
    assert set(exporting) < set(SUBPACKAGES)
