"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="qwen2_moe_a2_7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, moe_d_ff=1408, vocab_size=151936,
    num_experts=60, num_experts_per_tok=4, num_shared_experts=4,
    moe_group_size=256, qkv_bias=True,
)

SMOKE = ArchConfig(
    name="qwen2_moe_a2_7b_smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=64, moe_d_ff=64, vocab_size=128,
    num_experts=6, num_experts_per_tok=2, num_shared_experts=2,
    moe_group_size=32, qkv_bias=True, dtype="float32",
)
