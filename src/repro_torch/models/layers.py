"""Shared building blocks (port of ``repro.models.layers``, the subset the
Deformable-DETR slice uses).

Conventions kept from the JAX package: linear weights are stored
``(in_features, out_features)`` and applied as ``x @ w``, and leaf names
(``w``, ``b``, ``scale``, ``wi``, ``wd``, ...) match its pytree, so a
module's ``state_dict`` keys are the JAX paths.  Parameters are
``nn.Parameter``s on small ``nn.Module`` holders; ``init_*`` draw them
from an explicit ``torch.Generator`` on the CPU and move them to
``device``; ``apply_*`` are plain functions on tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dense_init(gen: Optional[torch.Generator], shape, in_axis: int = 0) -> torch.Tensor:
    """LeCun-normal fan-in init (CPU tensor; ``gen=None`` leaves it empty)."""
    if gen is None:
        return torch.empty(shape)
    return torch.randn(shape, generator=gen) / math.sqrt(shape[in_axis])


def embed_init(gen: Optional[torch.Generator], shape, scale: float = 1.0) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape)
    return torch.randn(shape, generator=gen) * scale


class Norm(nn.Module):
    """LayerNorm parameters: ``scale`` and ``bias``."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class Linear(nn.Module):
    """``x @ w (+ b)`` with ``w`` stored (d_in, d_out)."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)


class MLP(nn.Module):
    def __init__(self, wi: torch.Tensor, wd: torch.Tensor, wg: Optional[torch.Tensor] = None):
        super().__init__()
        self.wi = nn.Parameter(wi)
        self.wd = nn.Parameter(wd)
        self.wg = None if wg is None else nn.Parameter(wg)


def init_norm(cfg) -> Norm:
    if cfg.norm_type != "layernorm":
        raise NotImplementedError(f"norm_type={cfg.norm_type!r}: only layernorm is ported")
    return Norm(cfg.d_model)


def apply_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32: ``(x - mu) * rsqrt(var + eps) * scale + bias``."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(dt)


def init_linear(gen, d_in: int, d_out: int, bias: bool = False) -> Linear:
    return Linear(dense_init(gen, (d_in, d_out)), torch.zeros(d_out) if bias else None)


def apply_linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def init_mlp(gen, cfg) -> MLP:
    d, ff = cfg.d_model, cfg.d_ff
    wi = dense_init(gen, (d, ff))
    wd = dense_init(gen, (ff, d))
    wg = dense_init(gen, (d, ff)) if cfg.gated_mlp else None
    return MLP(wi, wd, wg)


def apply_mlp(p: MLP, cfg, x: torch.Tensor) -> torch.Tensor:
    h = x @ p.wi.to(x.dtype)
    if p.wg is not None:
        h = _act(cfg.act, x @ p.wg.to(x.dtype)) * h
    else:
        h = _act(cfg.act, h)
    return h @ p.wd.to(x.dtype)
