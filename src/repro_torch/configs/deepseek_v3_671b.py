"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, first 3 layers
dense [arXiv:2412.19437]."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab=129280,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    first_dense_layers=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    activation="silu",
))
