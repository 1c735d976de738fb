"""Granite-3.0-1B-A400M [hf:ibm-granite]: MoE 32e top-8, GQA(kv=8)."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    kv_heads=8, d_ff=512, vocab=49155, head_dim=64, rope_theta=1e4,
    n_experts=32, top_k=8, tie_embeddings=True,
    block_pattern=("attn",), mlp_pattern=("moe",))

REDUCED = ModelConfig(
    name="granite-moe-1b-a400m-reduced", n_layers=2, d_model=64, n_heads=4,
    kv_heads=2, d_ff=64, vocab=256, head_dim=16, n_experts=8, top_k=4,
    tie_embeddings=True, block_pattern=("attn",), mlp_pattern=("moe",),
    compute_dtype=torch.float32, loss_chunk=16)
