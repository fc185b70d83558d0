"""Softmax attention block (port of the non-causal, rope-free part of
``repro.models.attention`` that the DETR decoder's self-attention uses).

The JAX default ``impl="flash"`` is plain jnp (``models/flash.py``), not
a Pallas kernel, so plain PyTorch is the port: einsum -> fp32 softmax ->
einsum, GQA-native (query head ``h`` reads kv head ``h // groups``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq = nn.Parameter(wq)
        self.wk = nn.Parameter(wk)
        self.wv = nn.Parameter(wv)
        self.wo = nn.Parameter(wo)
        self.bq = None if bq is None else nn.Parameter(bq)
        self.bk = None if bk is None else nn.Parameter(bk)
        self.bv = None if bv is None else nn.Parameter(bv)


def init_attention(gen: Optional[torch.Generator], cfg) -> Attention:
    d = cfg.d_model
    ws = [layers.dense_init(gen, shape) for shape in
          ((d, cfg.q_dim), (d, cfg.kv_dim), (d, cfg.kv_dim), (cfg.q_dim, d))]
    biases = ()
    if cfg.qkv_bias:
        biases = (torch.zeros(cfg.q_dim), torch.zeros(cfg.kv_dim), torch.zeros(cfg.kv_dim))
    return Attention(*ws, *biases)


def _project_q(p: Attention, cfg, x):
    q = x @ p.wq.to(x.dtype)
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
    return q.reshape(*x.shape[:-1], cfg.num_heads, cfg.head_dim)


def _project_kv(p: Attention, cfg, x):
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if p.bk is not None:
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    k = k.reshape(*x.shape[:-1], cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(*x.shape[:-1], cfg.num_kv_heads, cfg.head_dim)
    return k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full non-causal attention: q (B,Sq,H,hd), k/v (B,Sk,Kv,hd) -> (B,Sq,H,hd)."""
    groups = q.shape[2] // k.shape[2]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def attention_fwd(p: Attention, cfg, x: torch.Tensor) -> torch.Tensor:
    """Self-attention block ``(B, S, d) -> (B, S, d)``: the JAX
    ``attention_fwd`` with ``causal=False, rope=False`` (the DETR decoder's)."""
    B, S, _ = x.shape
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x)
    out = attend(q, k, v)
    return out.reshape(B, S, cfg.q_dim) @ p.wo.to(x.dtype)
