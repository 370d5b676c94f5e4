from repro_torch.models.model import (
    LM,
    abstract_params,
    batch_spec,
    decode_step,
    init_caches,
    init_params,
    loss_fn,
    prefill,
    uses_embeds,
)

__all__ = [
    "LM",
    "abstract_params",
    "batch_spec",
    "decode_step",
    "init_caches",
    "init_params",
    "loss_fn",
    "prefill",
    "uses_embeds",
]
