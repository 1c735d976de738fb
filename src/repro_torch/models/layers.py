"""Primitive layers (the port of ``repro.models.layers``): pure functions
over parameter trees, indexed by name as in the reference (``p["w"]``).

Initialisers draw from an explicit ``torch.Generator`` on the device where
the tensors live; they give other numbers than the reference's
``jax.random`` keys, so tests carry the reference's parameters across
(``repro_torch.interop.lm_params_from_arrays``). :data:`META_INIT` in
place of a generator makes the same tree of ``meta`` tensors: shapes and
dtypes, no storage (the dry run's abstract parameters).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import torch

# a stand-in generator: initialisers given it return meta tensors
META_INIT = SimpleNamespace(device=torch.device("meta"))


def draw_from(gen) -> Optional[torch.Generator]:
    """The generator a random factory takes for ``gen`` (none on meta)."""
    return None if gen.device.type == "meta" else gen


def normal(gen: torch.Generator, shape, dtype=torch.float32,
           scale: float = 1.0) -> torch.Tensor:
    """Standard normal draws on ``gen``'s device, times ``scale``."""
    return torch.randn(shape, generator=draw_from(gen), device=gen.device,
                       dtype=dtype) * scale


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32,
               scale: Optional[float] = None):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": normal(gen, (d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Matmul in the activation dtype: params (stored f32 master) are cast
    to x.dtype — or to an explicit compute_dtype — at use."""
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    else:
        w = w.to(x.dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. The
    half-split convention (x[:D/2], x[D/2:] rotate together), not the
    interleaved one."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [half]
    ang = positions[..., None].to(torch.float32) * freqs        # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                          # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# short causal conv (Mamba)
# ---------------------------------------------------------------------------
def causal_conv1d_init(gen: torch.Generator, channels: int, width: int,
                       dtype=torch.float32):
    return {"w": normal(gen, (width, channels), dtype, width ** -0.5),
            "b": torch.zeros((channels,), dtype=dtype, device=gen.device)}


def causal_conv1d(p, x: torch.Tensor, state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, C] -> (y [B, S, C], new_state [B, width-1, C]).
    state carries the last (width-1) inputs for streaming decode."""
    w, b = p["w"], p["b"]
    width = w.shape[0]
    B, S, C = x.shape
    if state is None:
        state = torch.zeros((B, width - 1, C), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                       # [B, S+w-1, C]
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.zeros((B, S, C), dtype=acc, device=x.device)
    for i in range(width):
        y = y + xp[:, i:i + S, :].to(acc) * w[i].to(acc)
    y = (y + b.to(acc)).to(x.dtype)
    new_state = xp[:, S:, :]
    return y, new_state


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)

