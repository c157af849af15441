"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba-1 arch with dt/B/C RMSNorm [arXiv:2410.05355]."""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="falcon_mamba_7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024, ssm_state=16, expand=2, d_conv=4,
    ssm_norm=True,
)

SMOKE = ArchConfig(
    name="falcon_mamba_7b_smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=128, ssm_state=8, expand=2, d_conv=4,
    ssm_norm=True, dtype="float32",
)
