"""The PyTorch port and chip_smoke.py must not import JAX or anything of
the JAX package (not even its JAX-free modules): the port runs on a
machine without JAX."""
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "fisher_nerf_customized_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|fisher_nerf_customized_tpu\b"
    r"(?!_torch))", re.MULTILINE)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    text = path.read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path.name} imports {hits}"
    assert "importlib" not in text or "jax" not in text


def test_forbidden_pattern_catches_jax_imports():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "from fisher_nerf_customized_tpu.ops import fisher",
           "import fisher_nerf_customized_tpu",
           "    from fisher_nerf_customized_tpu.config import node"]
    good = ["import torch", "from fisher_nerf_customized_tpu_torch.ops "
            "import fisher", "from .ops import binning"]
    assert all(FORBIDDEN.search(s) for s in bad)
    assert not any(FORBIDDEN.search(s) for s in good)
