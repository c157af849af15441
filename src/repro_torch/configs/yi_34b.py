"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — llama-arch GQA [arXiv:2403.04652; hf]."""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="yi_34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, rope_theta=5_000_000.0,
)

SMOKE = ArchConfig(
    name="yi_34b_smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=192, vocab_size=128, dtype="float32",
)
