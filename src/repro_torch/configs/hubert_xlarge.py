"""hubert-xlarge [audio] — encoder-only, w2v2-style backbone
[arXiv:2106.07447].  Frame frontend is a STUB (precomputed frame embeddings);
no autoregressive decode step (decode shapes skipped)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    encoder_only=True,
    activation="gelu",
    tie_embeddings=False,
))
