"""Architecture + shape configuration registry (the port's copy of
``repro/configs/base.py``).

One :class:`ArchConfig` per assigned architecture (exact public configs) plus
a ``reduced()`` variant for CPU smoke tests.  :class:`ShapeConfig` describes
the assigned input shapes; ``runnable()`` encodes the skip rules (encoder-only
⇒ no decode; full-attention ⇒ no 500k context).

Departure from the reference: ``attn_impl`` takes ``"naive"``,
``"chunked"`` or ``"cuda"`` and any other value raises when the config is
built.  ``"cuda"`` is the port's name for the reference's ``"pallas"`` (the
hand-written flash-attention kernel, ``csrc/flash_attention.cu``).  The
reference sends an unknown value to the naive path without a word; here
that would let ``"pallas"`` skip the kernel silently, so it raises, and
``models/convert.py::config_from_reference`` maps the name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["ATTN_IMPLS", "ArchConfig", "ShapeConfig", "SHAPES", "register",
           "get_arch", "all_archs", "runnable", "runnable_cells"]

#: accepted ``ArchConfig.attn_impl`` values
ATTN_IMPLS = ("naive", "chunked", "cuda")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None  # final-logit softcap (gemma2)
    attn_softcap: Optional[float] = None  # attention-logit softcap (gemma2)
    local_window: Optional[int] = None  # sliding-window size
    layer_pattern: Tuple[str, ...] = ("global",)  # cycled over layers
    encoder_only: bool = False

    # mlp
    activation: str = "silu"  # silu | geglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # deepseek: leading dense layers

    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    hybrid_attn_period: int = 0  # zamba2: attention block every k layers
    shared_attn: bool = False  # zamba2: one weight-shared attn+MLP block

    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # attention implementation: "chunked" = flash-style online-softmax
    # blocks in plain torch (default); "naive" = materialized S² scores;
    # "cuda" = the hand-written flash-attention kernel (the reference's
    # "pallas").
    attn_impl: str = "chunked"
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024
    attn_pv_bf16: bool = False  # §Perf: bf16 P·V matmul (f32 accumulate)
    # MoE dispatch: "einsum" = GShard-style one-hot dispatch/combine
    # (baseline); "scatter" = index scatter/gather dispatch (§Perf
    # optimization — no (G,S,E,C) one-hot materialization, no fake FLOPs).
    moe_impl: str = "einsum"
    # §Perf: bf16 dispatch/combine one-hots (exact for 0/1 masks; gates
    # rounded to bf16 in combine)
    moe_bf16_dispatch: bool = False

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl={self.attn_impl!r} is not one of {ATTN_IMPLS} "
                f"(the reference's 'pallas' is 'cuda' here)")

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def sub_quadratic(self) -> bool:
        """Supports 500k contexts (SSM / hybrid-with-O(1)-state decode)."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """'attn' | 'local' | 'ssm' per layer index."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            p = max(self.hybrid_attn_period, 1)
            return "attn" if (i % p == p - 1) else "ssm"
        return (
            "local"
            if self.layer_pattern[i % len(self.layer_pattern)] == "local"
            else "attn"
        )

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        counted_shared = False
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind != "ssm" and self.shared_attn:
                if counted_shared:
                    continue  # weight-shared block counted once
                counted_shared = True
            if kind == "ssm":
                # matches models/mamba.py: single B/C group, conv over x only
                d_in = self.ssm_heads * self.ssm_head_dim
                conv = 4 * d_in
                total += d * (2 * d_in + 2 * self.ssm_state
                              + self.ssm_heads) + conv + d_in * d
            else:
                if self.mla:
                    total += d * self.q_lora_rank
                    total += self.q_lora_rank * self.n_heads * (
                        self.nope_head_dim + self.rope_head_dim
                    )
                    total += d * (self.kv_lora_rank + self.rope_head_dim)
                    total += self.kv_lora_rank * self.n_heads * (
                        self.nope_head_dim + self.v_head_dim
                    )
                    total += self.n_heads * self.v_head_dim * d
                else:
                    total += d * self.n_heads * hd  # q
                    total += 2 * d * self.n_kv_heads * hd  # kv
                    total += self.n_heads * hd * d  # o
            # mlp / moe (ssm blocks are the whole mixer — no separate MLP)
            if kind == "ssm":
                continue
            gated = 3 if self.activation in ("silu", "geglu") else 2
            if self.is_moe and i >= self.first_dense_layers:
                total += self.n_experts * gated * d * ff
                total += self.n_shared_experts * gated * d * ff
                total += d * self.n_experts  # router
            else:
                dense_ff = ff if not self.is_moe else ff * max(
                    self.top_k + self.n_shared_experts, 1
                )
                total += gated * d * dense_ff
        return total

    def active_params(self) -> int:
        """Per-token active parameters (MoE: top-k + shared only)."""
        if not self.is_moe:
            return self.num_params()
        d, ff = self.d_model, self.d_ff
        gated = 3 if self.activation in ("silu", "geglu") else 2
        moe_layers = self.n_layers - self.first_dense_layers
        dense = self.num_params() - moe_layers * self.n_experts * gated * d * ff
        return dense + moe_layers * self.top_k * gated * d * ff

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=2 if self.hybrid_attn_period <= 2 else self.hybrid_attn_period,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            first_dense_layers=min(self.first_dense_layers, 1),
            q_lora_rank=min(self.q_lora_rank, 32) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 16) if self.kv_lora_rank else 0,
            rope_head_dim=8 if self.mla else self.rope_head_dim,
            nope_head_dim=8 if self.mla else self.nope_head_dim,
            v_head_dim=16 if self.mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_head_dim=16 if self.ssm_heads else self.ssm_head_dim,
            ssm_chunk=16,
            local_window=min(self.local_window, 32) if self.local_window else None,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, seq_len=min(self.seq_len, 64), global_batch=min(self.global_batch, 2)
        )


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs.all_archs  # noqa: F401  (populate registry)

    return _REGISTRY[name]


def all_archs() -> List[str]:
    import repro_torch.configs.all_archs  # noqa: F401

    return sorted(_REGISTRY)


def runnable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full attention: 500k context requires sub-quadratic arch"
    return True, ""


def runnable_cells() -> List[Tuple[str, str]]:
    cells = []
    for a in all_archs():
        cfg = get_arch(a)
        for s in SHAPES.values():
            ok, _ = runnable(cfg, s)
            if ok:
                cells.append((a, s.name))
    return cells
