"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]: GQA(kv=8), tied embeddings."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32, kv_heads=8,
    d_ff=8192, vocab=128256, head_dim=64, rope_theta=5e5,
    tie_embeddings=True,
    block_pattern=("attn",), mlp_pattern=("dense",))

REDUCED = ModelConfig(
    name="llama3.2-1b-reduced", n_layers=2, d_model=64, n_heads=4,
    kv_heads=2, d_ff=160, vocab=256, head_dim=16, tie_embeddings=True,
    block_pattern=("attn",), mlp_pattern=("dense",),
    compute_dtype=torch.float32, loss_chunk=16)
