"""Mamba2-1.3B [arXiv:2405.21060]: attn-free SSD stack, state=128."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", n_layers=48, d_model=2048, n_heads=1, kv_heads=1,
    d_ff=0, vocab=50280, ssm_state=128, ssm_headdim=64, tie_embeddings=True,
    block_pattern=("ssm",), mlp_pattern=("none",))

REDUCED = ModelConfig(
    name="mamba2-1.3b-reduced", n_layers=2, d_model=64, n_heads=1,
    kv_heads=1, d_ff=0, vocab=256, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, tie_embeddings=True,
    block_pattern=("ssm",), mlp_pattern=("none",),
    compute_dtype=torch.float32, loss_chunk=16)
