"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens.

Frontend stub per assignment: the EnCodec encoder/decoder is out of scope;
inputs are already discrete codes (vocab=2048). The released model predicts 4
codebooks with a delay pattern; we model the primary stream (noted in
DESIGN §4). Sinusoidal positions + LayerNorm + GELU, MHA (kv == heads)."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", n_layers=48, d_model=2048, n_heads=32,
    kv_heads=32, d_ff=8192, vocab=2048, head_dim=64, norm="ln",
    mlp_act="gelu", pos="sinusoidal", frontend="audio",
    block_pattern=("attn",), mlp_pattern=("dense",))

REDUCED = ModelConfig(
    name="musicgen-large-reduced", n_layers=2, d_model=64, n_heads=4,
    kv_heads=4, d_ff=160, vocab=64, head_dim=16, norm="ln", mlp_act="gelu",
    pos="sinusoidal", frontend="audio",
    block_pattern=("attn",), mlp_pattern=("dense",),
    compute_dtype=torch.float32, loss_chunk=16)
