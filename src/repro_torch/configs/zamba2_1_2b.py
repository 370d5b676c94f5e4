"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks every 6
layers [arXiv:2411.15242]."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_attn_period=6,
    shared_attn=True,
    activation="gelu",
))
