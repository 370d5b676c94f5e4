from repro_torch.models.model import (
    LM,
    decode_step,
    init_caches,
    init_params,
    loss_fn,
    prefill,
    uses_embeds,
)

__all__ = [
    "LM",
    "decode_step",
    "init_caches",
    "init_params",
    "loss_fn",
    "prefill",
    "uses_embeds",
]
