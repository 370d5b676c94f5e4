"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].  d_inner = 2·d_model, head_dim 64 ⇒ 32 SSD heads."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_heads=32,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
))
