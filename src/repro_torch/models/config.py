"""Architecture configuration and per-site spec resolution (port of
``repro.models.config``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.rebranch import ReBranchSpec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A config's dtype (the JAX package's name, e.g. ``"bfloat16"``, or a
    ``torch.dtype``) as a ``torch.dtype``."""
    return dtype if isinstance(dtype, torch.dtype) else _DTYPES[str(dtype)]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    mlp_type: str = "swiglu"       # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False            # qwen2-vl M-RoPE (3-section rotary)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_group_size: int = 1024
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    ssm_norm: bool = False
    # --- hybrid (hymba) ---
    sliding_window: int = 0        # 0 -> full attention everywhere
    full_attn_layers: tuple = ()
    # --- multi-codebook audio (musicgen) ---
    num_codebooks: int = 0
    # --- frontend stub ---
    frontend: str = "none"         # none | vision | audio
    # --- technique ---
    rebranch: ReBranchSpec = dataclasses.field(default_factory=ReBranchSpec)
    # ((address, ReBranchSpec), ...) resolved by spec_for (longest prefix)
    rebranch_overrides: tuple = ()
    # --- numerics ---
    dtype: Any = "bfloat16"        # activation dtype, the JAX package's name
    remat: bool = True             # per-block activation checkpointing (train)
    attn_chunk: int = 1024         # online-softmax KV chunk of prefill

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.dt_rank == 0 and self.ssm_state:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def scan_layers(self) -> bool:
        """Stacked per-layer params (leading L dim), as the JAX package's
        ``lax.scan`` keeps them; the port loops over L in Python.  Hybrid
        archs keep a per-layer list."""
        return self.family != "hybrid"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def uses_full_attention(self, layer_idx: int) -> bool:
        if self.sliding_window == 0:
            return True
        return layer_idx in self.full_attn_layers


def spec_for(cfg, site: str):
    """The ReBranchSpec governing one named site: the LONGEST matching
    override in ``cfg.rebranch_overrides`` (exact site or ancestor
    prefix), else the config-wide ``cfg.rebranch``."""
    return resolve_override(getattr(cfg, "rebranch_overrides", ()),
                            site, cfg.rebranch)


def resolve_override(entries, site: str, default):
    """Longest-prefix resolution over ((address, spec), ...) entries — the
    one resolver both ``spec_for`` and ``PlacementPlan.spec`` call."""
    best, best_len = None, -1
    for s, spec in entries:
        if (s == site or site.startswith(s + ".")) and len(s) > best_len:
            best, best_len = spec, len(s)
    return default if best is None else best
