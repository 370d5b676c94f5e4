from repro_torch.imputers.base import (
    ImputationEngine,
    ImputationService,
    Imputer,
    ImputeStore,
)
from repro_torch.imputers.mean import MeanImputer
from repro_torch.imputers.knn import KnnImputer
from repro_torch.imputers.gbdt import GbdtImputer
from repro_torch.imputers.locater import LocaterImputer

__all__ = [
    "ImputationEngine",
    "ImputationService",
    "Imputer",
    "ImputeStore",
    "MeanImputer",
    "KnnImputer",
    "GbdtImputer",
    "LocaterImputer",
]
