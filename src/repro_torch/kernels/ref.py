"""Plain PyTorch oracles for multi-scale deformable attention (MSDA).

Port of ``repro.kernels.ref``:

* :func:`msda_ref` — the vectorised oracle every kernel is held against,
  and the ``"ref"`` backend.
* :func:`msda_grid_sample_baseline` — the un-fused ``F.grid_sample``
  composition (MMCV's pure-PyTorch fallback, the paper's "Baseline"
  column).  It is a yardstick: the port never calls it on its path.

Conventions (MMCV ``MultiScaleDeformableAttnFunction``):

* ``value``:              ``(B, S, H, D)`` with ``S = sum_l H_l * W_l``
* ``spatial_shapes``:     static tuple ``((H_0, W_0), ...)``
* ``sampling_locations``: ``(B, Q, H, L, P, 2)`` normalised to ``[0, 1]``,
  last axis ``(x, y)``
* ``attention_weights``:  ``(B, Q, H, L, P)`` (softmaxed over ``L*P``)
* returns                 ``(B, Q, H * D)``

Bilinear sampling follows ``F.grid_sample(align_corners=False,
padding_mode='zeros')``: pixel coords ``px = x * W - 0.5`` and
out-of-bounds corners contribute zero.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Shapes = Tuple[Tuple[int, int], ...]


def _bilinear_corners(loc_x, loc_y, H, W):
    """Corner origin + fractions for grid_sample(align_corners=False)."""
    px = loc_x * W - 0.5
    py = loc_y * H - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    return x0, y0, px - x0, py - y0


def _gather_2d(value_l, x, y, H, W):
    """Zero-padded gather: value_l (B,Hh,HW,D), x/y (B,Q,Hh,P) int corners."""
    inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    flat = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)  # (B,Q,Hh,P)
    B, Q, Hh, P = flat.shape
    D = value_l.shape[-1]
    idx = flat.permute(0, 2, 1, 3).reshape(B, Hh, Q * P, 1).expand(B, Hh, Q * P, D)
    out = torch.gather(value_l, 2, idx).reshape(B, Hh, Q, P, D)
    out = out.permute(0, 2, 1, 3, 4)  # (B,Q,Hh,P,D)
    return out * inb[..., None].to(out.dtype)


def msda_ref(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor, attention_weights: torch.Tensor) -> torch.Tensor:
    """Vectorised MSDA oracle in fp32. See module docstring for shapes."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value S={S} does not match {spatial_shapes}")
    if tuple(attention_weights.shape) != (B, Q, H, L, P):
        raise ValueError(f"attention_weights {tuple(attention_weights.shape)} "
                         f"!= {(B, Q, H, L, P)}")
    out_dtype = value.dtype
    value_t = value.float().permute(0, 2, 1, 3)  # (B,H,S,D)
    loc = sampling_locations.float()
    attn = attention_weights.float()
    out = torch.zeros((B, Q, H, D), dtype=torch.float32, device=value.device)
    offset = 0
    for l, (Hl, Wl) in enumerate(spatial_shapes):
        value_l = value_t[:, :, offset:offset + Hl * Wl]
        offset += Hl * Wl
        loc_l = loc[:, :, :, l]  # (B,Q,H,P,2)
        x0f, y0f, lx, ly = _bilinear_corners(loc_l[..., 0], loc_l[..., 1], Hl, Wl)
        x0 = x0f.to(torch.int64)
        y0 = y0f.to(torch.int64)
        sampled = (
            _gather_2d(value_l, x0, y0, Hl, Wl) * ((1 - lx) * (1 - ly))[..., None]
            + _gather_2d(value_l, x0 + 1, y0, Hl, Wl) * (lx * (1 - ly))[..., None]
            + _gather_2d(value_l, x0, y0 + 1, Hl, Wl) * ((1 - lx) * ly)[..., None]
            + _gather_2d(value_l, x0 + 1, y0 + 1, Hl, Wl) * (lx * ly)[..., None]
        )  # (B,Q,H,P,D)
        out = out + torch.einsum("bqhpd,bqhp->bqhd", sampled, attn[:, :, :, l])
    return out.reshape(B, Q, H * D).to(out_dtype)


def grid_sample(input_: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(input, grid, align_corners=False, mode='bilinear',
    padding_mode='zeros')``: input (B, C, H, W), grid (B, Hg, Wg, 2) in
    [-1, 1] (x, y) -> (B, C, Hg, Wg)."""
    return F.grid_sample(input_, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def msda_grid_sample_baseline(value: torch.Tensor, spatial_shapes: Shapes,
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor) -> torch.Tensor:
    """The paper's "Baseline": MMCV's pure grid-sample composition.

    Materialises per-level sampled tensors and a (B*H, D, Q, L*P)
    intermediate — the memory-traffic-heavy path the paper beats.
    """
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    value = value.float()
    grids = 2.0 * sampling_locations.float() - 1.0  # (B,Q,H,L,P,2)
    sampled_all = []
    offs = 0
    for l, (Hl, Wl) in enumerate(spatial_shapes):
        v_l = value[:, offs:offs + Hl * Wl]
        offs += Hl * Wl
        v_l = v_l.permute(0, 2, 3, 1).reshape(B * H, D, Hl, Wl)
        g_l = grids[:, :, :, l].permute(0, 2, 1, 3, 4).reshape(B * H, Q, P, 2)
        sampled_all.append(grid_sample(v_l, g_l))  # (B*H, D, Q, P)
    stacked = torch.stack(sampled_all, dim=-2).reshape(B * H, D, Q, L * P)
    attn = attention_weights.float().permute(0, 2, 1, 3, 4).reshape(B * H, 1, Q, L * P)
    out = (stacked * attn).sum(-1)  # (B*H, D, Q)
    return out.reshape(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)
