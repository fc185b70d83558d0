"""MSDAttention: the paper's op as a model module (port of
``repro.core.msda`` without the mesh logic).

Standard Deformable-DETR parameterisation: per-query learned sampling
offsets around reference points + softmaxed attention weights,
value/output projections.  :func:`attention_plan` builds the cached
:class:`~repro_torch.kernels.plan.MsdaPlan` for a module's static
geometry; repeated forwards with the same geometry reuse it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import plan as plan_mod
from repro_torch.models import layers


def level_ref_points(levels, device="cuda") -> torch.Tensor:
    """Normalised (x, y) centers for every pixel of every level: (S, 2)."""
    device = resolve_device(device)
    out = []
    for (h, w) in levels:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(torch.stack([gx, gy], -1).reshape(h * w, 2))
    return torch.cat(out, dim=0)


class MSDAttention(nn.Module):
    def __init__(self, value_proj, out_proj, w_offsets, b_offsets, w_weights, b_weights):
        super().__init__()
        self.value_proj = nn.Parameter(value_proj)
        self.out_proj = nn.Parameter(out_proj)
        self.w_offsets = nn.Parameter(w_offsets)
        self.b_offsets = nn.Parameter(b_offsets)
        self.w_weights = nn.Parameter(w_weights)
        self.b_weights = nn.Parameter(b_weights)


def init_msda_attention(gen: Optional[torch.Generator], d_model: int, msda_cfg) -> MSDAttention:
    L = len(msda_cfg.levels)
    H, Pn = msda_cfg.num_heads, msda_cfg.num_points
    value_proj = layers.dense_init(gen, (d_model, d_model))
    out_proj = layers.dense_init(gen, (d_model, d_model))
    w_weights = layers.dense_init(gen, (d_model, H * L * Pn)) * 0.01
    # Deformable-DETR offset-bias init: points spread on a ring per head
    theta = torch.arange(H, dtype=torch.float32) * (2.0 * math.pi / H)
    grid = torch.stack([torch.cos(theta), torch.sin(theta)], -1)  # (H,2)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None].repeat(1, L, Pn, 1)
    scale = (torch.arange(Pn, dtype=torch.float32) + 1.0)[None, None, :, None]
    return MSDAttention(
        value_proj, out_proj,
        w_offsets=torch.zeros((d_model, H * L * Pn * 2)),
        b_offsets=(grid * scale).reshape(-1),
        w_weights=w_weights,
        b_weights=torch.zeros(H * L * Pn))


def attention_plan(msda_cfg, *, num_queries: int, head_dim: int,
                   dtype) -> plan_mod.MsdaPlan:
    """The module's inference :class:`MsdaPlan` for one static geometry
    (cached).  The slab follows the operand dtype and accumulates in fp32."""
    spec = plan_mod.MsdaSpec(
        spatial_shapes=msda_cfg.levels,
        num_heads=msda_cfg.num_heads,
        head_dim=head_dim,
        num_points=msda_cfg.num_points,
        num_queries=num_queries,
        dtype=plan_mod.dtype_name(dtype),
    )
    return plan_mod.msda_plan(spec, backend=msda_cfg.backend)


def msda_attention(p: MSDAttention, msda_cfg, query: torch.Tensor,
                   value_feats: torch.Tensor, reference_points: torch.Tensor, *,
                   valid_ratios: Optional[torch.Tensor] = None) -> torch.Tensor:
    """query (B,Q,d), value_feats (B,S,d), reference_points (B,Q,2) in [0,1];
    ``valid_ratios`` (B,L,2) x,y fractions of each padded level in use."""
    levels = msda_cfg.levels
    L, H, Pn = len(levels), msda_cfg.num_heads, msda_cfg.num_points
    B, Q, d = query.shape
    D = d // H
    dt = query.dtype
    value = (value_feats @ p.value_proj.to(dt)).reshape(B, -1, H, D)

    off = query @ p.w_offsets.to(dt) + p.b_offsets.to(dt)
    off = off.reshape(B, Q, H, L, Pn, 2).float()
    wh = torch.tensor([[w, h] for (h, w) in levels], dtype=torch.float32,
                      device=query.device)  # (L,2) x,y order
    refs = reference_points[:, :, None, None, None, :]
    if valid_ratios is not None:
        # scaling the reference points by the ratio (offsets stay normalised
        # by the padded extents) lands every sample on the pixel it hits in
        # the unpadded level; pad-region corners gather zeros
        refs = refs * valid_ratios[:, None, None, :, None, :].float()
    loc = refs + off / wh[None, None, None, :, None, :]

    aw = query @ p.w_weights.to(dt) + p.b_weights.to(dt)
    aw = torch.softmax(aw.reshape(B, Q, H, L * Pn).float(), dim=-1)
    aw = aw.reshape(B, Q, H, L, Pn)

    plan = attention_plan(msda_cfg, num_queries=Q, head_dim=D, dtype=dt)
    out = plan(value.to(dt), loc, aw.to(dt))
    return out.to(dt) @ p.out_proj.to(dt)
