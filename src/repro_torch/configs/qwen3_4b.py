"""Qwen3-4B [hf:Qwen/Qwen3-*]: GQA(kv=8), qk-norm, decoupled head_dim=128."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, kv_heads=8,
    d_ff=9728, vocab=151936, head_dim=128, rope_theta=1e6, qk_norm=True,
    block_pattern=("attn",), mlp_pattern=("dense",))

REDUCED = ModelConfig(
    name="qwen3-4b-reduced", n_layers=2, d_model=64, n_heads=4, kv_heads=2,
    d_ff=160, vocab=256, head_dim=16, qk_norm=True,
    block_pattern=("attn",), mlp_pattern=("dense",),
    compute_dtype=torch.float32, loss_chunk=16)
