"""InternVL2-2B [arXiv:2404.16821]: InternLM2-1.8B backbone + InternViT stub.

Frontend stub per assignment: input_specs supplies precomputed ViT patch
embeddings [B, 256, 1024]; a linear projector maps them into the token
stream ahead of the text."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", n_layers=24, d_model=2048, n_heads=16, kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128, rope_theta=1e6,
    frontend="vision", vision_tokens=256, vision_dim=1024,
    block_pattern=("attn",), mlp_pattern=("dense",))

REDUCED = ModelConfig(
    name="internvl2-2b-reduced", n_layers=2, d_model=64, n_heads=4,
    kv_heads=2, d_ff=160, vocab=256, head_dim=16,
    frontend="vision", vision_tokens=8, vision_dim=32,
    block_pattern=("attn",), mlp_pattern=("dense",),
    compute_dtype=torch.float32, loss_chunk=16)
