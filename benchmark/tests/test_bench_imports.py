"""Nothing the harness or the reference imports has the top-level name
jax, jaxlib, flax or fisher_nerf_customized_tpu (each compared whole:
the port's name begins with the JAX package's), and the reference
imports nothing of the port."""
import ast
import glob
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "fisher_nerf_customized_tpu"}
PORT = "fisher_nerf_customized_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in glob.glob(os.path.join(HERE, "**", "*.py"),
                                 recursive=True)
            if "/tests/" not in p]


def test_no_forbidden_import_in_the_sources():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        assert PORT not in set(_imports(path)), path


def test_forbidden_modules_compares_whole_names():
    from harness.core import forbidden_modules
    assert forbidden_modules([PORT, PORT + ".ops", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", PORT, "flax"]) == ["flax", "jax"]
    assert forbidden_modules(["fisher_nerf_customized_tpu.ops"]) == [
        "fisher_nerf_customized_tpu"]


def test_loaded_modules_in_a_fresh_interpreter():
    """Import everything the harness runs, the port's modules that the
    entries reach included, with the forbidden names blocked."""
    code = f"""
import importlib.abc, sys, glob, os, importlib.util
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in {sorted(FORBIDDEN)!r}:
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{HERE!r}, {ROOT!r}]
import run, control
from harness import core, port, trace, readers, roofline
from reference import gaussians, fisher, recon, scene, image_metrics, poses, compare
from entries import episode, eval, plan
import fisher_nerf_customized_tpu_torch.cli
import fisher_nerf_customized_tpu_torch.engine.driver
import fisher_nerf_customized_tpu_torch.models.perceptual
for p in glob.glob(os.path.join({HERE!r}, 'metrics', '*.py')):
    run.reader(os.path.basename(p)[:-3])
bad = core.forbidden_modules()
assert not bad, bad
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
