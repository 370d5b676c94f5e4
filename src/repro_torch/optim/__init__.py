from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.schedule import clip_by_global_norm, warmup_cosine
from repro_torch.optim.compression import (
    compress,
    decompress,
    ef_compress_grads,
    init_residual,
)

__all__ = [
    "adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
    "clip_by_global_norm", "warmup_cosine",
    "compress", "decompress", "ef_compress_grads", "init_residual",
]
