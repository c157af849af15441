"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048, 4 codebooks
[arXiv:2306.05284; hf].  The EnCodec frontend is a stub: the inputs are
token ids per codebook (the backbone only).  As in the JAX package, the
published dims run on the zoo's RoPE + GELU-MLP path (``mlp_type="gelu"``)
in place of MusicGen's learned positions.
"""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="musicgen_large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, num_codebooks=4,
    mlp_type="gelu", rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="musicgen_large_smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=64, num_codebooks=4, mlp_type="gelu",
    dtype="float32",
)
