"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
The vision frontend is a stub (precomputed patch embeddings), as in the
JAX package.  M-RoPE splits the rotary half 2:1:1 ([32, 16, 16] at
head_dim 128) as the JAX package does, not Hugging Face's [16, 24, 24]."""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="qwen2_vl_2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, mrope=True, qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen2_vl_2b_smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=128, mrope=True, qkv_bias=True,
    tie_embeddings=True, dtype="float32",
)
