"""Jamba-1.5-Large 398B [arXiv:2403.19887]: Mamba+attn 1:7, MoE 16e top-2.

Period-8 group: attention at slot 4 (as in the released config), Mamba
elsewhere; MoE on every other layer."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
    kv_heads=8, d_ff=24576, vocab=65536, head_dim=128,
    n_experts=16, top_k=2, ssm_state=128, ssm_headdim=64,
    block_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    mlp_pattern=("dense", "moe"))

REDUCED = ModelConfig(
    name="jamba-1.5-large-398b-reduced", n_layers=8, d_model=64, n_heads=4,
    kv_heads=2, d_ff=128, vocab=256, head_dim=16, n_experts=4, top_k=2,
    ssm_state=16, ssm_headdim=16, ssm_chunk=16,
    block_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    mlp_pattern=("dense", "moe"),
    compute_dtype=torch.float32, loss_chunk=16)
