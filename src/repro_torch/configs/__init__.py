# The registry module is loaded first: loading a submodule binds its name
# on the package, and ``all_archs`` names both that module and the
# function below, which must win.
import repro_torch.configs.all_archs  # noqa: F401  (populate the registry)
from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    ShapeConfig,
    all_archs,
    get_arch,
    runnable,
    runnable_cells,
)

__all__ = [
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "all_archs",
    "get_arch",
    "runnable",
    "runnable_cells",
]
