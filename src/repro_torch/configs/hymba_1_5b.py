"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads, SWA in most
layers with 3 global-attention layers [arXiv:2411.13676; hf].
Meta tokens elided, as in the JAX package."""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="hymba_1_5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001, ssm_state=16,
    sliding_window=2048, full_attn_layers=(0, 15, 31),
)

SMOKE = ArchConfig(
    name="hymba_1_5b_smoke", family="hybrid",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=128, ssm_state=8,
    sliding_window=8, full_attn_layers=(0, 2), dtype="float32",
)
