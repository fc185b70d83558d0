"""Glue around the fused forward kernel (port of the fused part
of ``repro.kernels.ops``).

The JAX package transposes to head-major and packs a zero-padded
super-slab before its Pallas launch.  The CUDA kernel reads the public
layout in place and writes ``(B, Q, H*D)``, so the move here is only to
contiguous operands (the wrapper checks the rest).  On CUDA tensors the call
goes through :class:`FusedForward`, whose backward raises until the fused
backward kernel lands; on CPU tensors the plain version runs and autograd
differentiates it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import msda_fwd
from repro_torch.kernels.msda_fwd import Shapes


class FusedForward(torch.autograd.Function):
    """The CUDA fused forward as an autograd node (inference only)."""

    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes):
        return msda_fwd.msda_fwd_fused(value, loc, attn, spatial_shapes)

    @staticmethod
    def backward(ctx, gout):
        raise NotImplementedError(
            "the MSDA backward on CUDA needs the fused backward kernel "
            "(msda_bwd_fused), which the next slice of the port adds")


def msda_fused(value: torch.Tensor, loc: torch.Tensor, attn: torch.Tensor,
               spatial_shapes: Shapes) -> torch.Tensor:
    """(B,S,H,D), (B,Q,H,L,P,2), (B,Q,H,L,P) -> (B,Q,H*D) fp32."""
    args = (value.contiguous(), loc.contiguous(), attn.contiguous(),
            tuple(spatial_shapes))
    if value.is_cuda:
        return FusedForward.apply(*args)
    return msda_fwd.msda_fwd_fused(*args)
