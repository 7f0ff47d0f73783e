"""`python -m fisher_nerf_customized_tpu_torch.main_navigation ...`: the
frontier-only pipeline; see cli.py::main_navigation."""
from .cli import main_navigation

if __name__ == "__main__":
    main_navigation()
