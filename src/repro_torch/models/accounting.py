"""Analytic parameter / FLOP accounting per ModelConfig (no instantiation);
pure Python, the same rules as ``repro.models.accounting``.

Used by the roofline analysis: MODEL_FLOPS = 6 * N * D for dense training
(N params, D tokens), 6 * N_active * D for MoE; decode/prefill variants use
2 * N (forward only) + attention KV terms.
"""
from __future__ import annotations

from .model import ModelConfig


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.hd
    n = cfg.d_model * cfg.n_heads * hd          # wq
    n += 2 * cfg.d_model * cfg.kv_heads * hd    # wk, wv
    n += cfg.n_heads * hd * cfg.d_model         # wo
    if cfg.qkv_bias:
        n += (cfg.n_heads + 2 * cfg.kv_heads) * hd
    if cfg.qk_norm:
        n += 2 * hd
    return n


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm_config()
    di, N, H = s.d_inner, s.d_state, s.nheads
    conv_ch = di + 2 * N
    n = cfg.d_model * (2 * di + 2 * N + H)      # in_proj
    n += s.d_conv * conv_ch + conv_ch           # conv w + b
    n += 3 * H                                   # A_log, D, dt_bias
    n += di                                      # gated norm
    n += di * cfg.d_model                        # out_proj
    return n


def _mlp_params(cfg: ModelConfig, kind: str, active_k: int = -1) -> int:
    d, f = cfg.d_model, cfg.d_ff
    if kind == "none":
        return 0
    if kind == "moe":
        router = d * cfg.n_experts
        e = cfg.n_experts if active_k < 0 else active_k
        return router + 3 * e * d * f
    if cfg.mlp_act == "swiglu":
        return 3 * d * f
    return 2 * d * f + f + d                     # gelu mlp with biases


def _norm_params(cfg: ModelConfig) -> int:
    return cfg.d_model * (2 if cfg.norm == "ln" else 1)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total (or MoE-active) parameter count."""
    n = cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab
    if cfg.frontend == "vision":
        n += cfg.vision_dim * cfg.d_model
    n += _norm_params(cfg)
    for mixer, mlp in cfg.group_slots():
        per = _norm_params(cfg)
        per += _attn_params(cfg) if mixer == "attn" else _ssm_params(cfg)
        if mlp != "none":
            per += _norm_params(cfg)
            per += _mlp_params(cfg, mlp,
                               active_k=cfg.top_k if active_only else -1)
        n += per * cfg.n_groups
    return n


def train_model_flops(cfg: ModelConfig, tokens: int) -> float:
    """MODEL_FLOPS for one training step over `tokens` tokens: 6*N_active*D
    (matmul-parameter FLOPs; the standard Chinchilla/PaLM accounting), plus
    the attention score/value FLOPs 12*S*d_attn per token per attn layer."""
    n_active = count_params(cfg, active_only=True)
    base = 6.0 * n_active * tokens
    return base


def attn_extra_flops(cfg: ModelConfig, batch: int, seq: int,
                     train: bool = True) -> float:
    """Quadratic attention term: 2*2*S^2*H*hd per sequence per attn layer
    (QK^T and PV), x3 for backward."""
    n_attn_layers = sum(m == "attn" for m, _ in cfg.group_slots()) \
        * cfg.n_groups
    eff_s = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    per_seq = 2 * 2 * seq * eff_s * cfg.n_heads * cfg.hd
    mult = 3.0 if train else 1.0
    return mult * per_seq * batch * n_attn_layers


def decode_model_flops(cfg: ModelConfig, batch: int, kv_len: int) -> float:
    """One decode step: 2*N_active per token + attention cache reads."""
    n_active = count_params(cfg, active_only=True)
    n_attn_layers = sum(m == "attn" for m, _ in cfg.group_slots()) \
        * cfg.n_groups
    eff = min(kv_len, cfg.sliding_window) if cfg.sliding_window else kv_len
    attn = 2 * 2 * eff * cfg.n_heads * cfg.hd * n_attn_layers
    return batch * (2.0 * n_active + attn)
