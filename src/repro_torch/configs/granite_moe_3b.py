"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8)
expert d_ff=512 vocab=49155, MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-*-base family; hf]."""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="granite_moe_3b", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, moe_d_ff=512, vocab_size=49155,
    num_experts=40, num_experts_per_tok=8,
    moe_group_size=256, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="granite_moe_3b_smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=64, moe_d_ff=64, vocab_size=128,
    num_experts=8, num_experts_per_tok=2, moe_group_size=32,
    tie_embeddings=True, dtype="float32",
)
