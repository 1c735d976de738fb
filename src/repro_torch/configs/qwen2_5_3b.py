"""Qwen2.5-3B [hf:Qwen/Qwen2.5-*]: GQA(kv=2), QKV bias, RMSNorm, SwiGLU."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16, kv_heads=2,
    d_ff=11008, vocab=151936, head_dim=128, rope_theta=1e6, qkv_bias=True,
    block_pattern=("attn",), mlp_pattern=("dense",))

REDUCED = ModelConfig(
    name="qwen2.5-3b-reduced", n_layers=2, d_model=64, n_heads=4, kv_heads=2,
    d_ff=160, vocab=256, head_dim=16, qkv_bias=True,
    block_pattern=("attn",), mlp_pattern=("dense",),
    compute_dtype=torch.float32, loss_chunk=16)
