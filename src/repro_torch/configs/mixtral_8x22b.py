"""Mixtral-8x22B [arXiv:2401.04088]: MoE 8e top-2, GQA(kv=8), SWA."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48, kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128, rope_theta=1e6,
    sliding_window=4096, n_experts=8, top_k=2,
    block_pattern=("attn",), mlp_pattern=("moe",))

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced", n_layers=2, d_model=64, n_heads=4,
    kv_heads=2, d_ff=128, vocab=256, head_dim=16, sliding_window=8,
    n_experts=4, top_k=2, block_pattern=("attn",), mlp_pattern=("moe",),
    compute_dtype=torch.float32, loss_chunk=16)
