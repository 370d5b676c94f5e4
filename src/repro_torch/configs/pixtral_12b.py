"""pixtral-12b [vlm] — pixtral-ViT frontend (stub) + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].  The modality frontend is a STUB: train /
prefill inputs are precomputed patch embeddings (B, S, d_model)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
    activation="silu",
))
