"""StarCoder2-7B [arXiv:2402.19173]: GQA(kv=4), RoPE, LayerNorm, GELU 4x MLP."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36, kv_heads=4,
    d_ff=18432, vocab=49152, head_dim=128, rope_theta=1e5,
    norm="ln", mlp_act="gelu",
    block_pattern=("attn",), mlp_pattern=("dense",))

REDUCED = ModelConfig(
    name="starcoder2-7b-reduced", n_layers=2, d_model=72, n_heads=6,
    kv_heads=2, d_ff=288, vocab=256, head_dim=16, norm="ln", mlp_act="gelu",
    block_pattern=("attn",), mlp_pattern=("dense",),
    compute_dtype=torch.float32, loss_chunk=16)
