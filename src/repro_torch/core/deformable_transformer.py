"""Deformable-DETR inference — the paper's own workload (port of the
inference part of ``repro.core.deformable_transformer``).

Encoder: every pixel of the multi-scale pyramid is a query; each layer
applies MSDA over the pyramid (Q = S = sum HW, 87296 at the paper's
1024x1024 scale) followed by an FFN.  Decoder: 300 object queries with
self-attention + MSDA cross-attention into the encoder memory.  Heads:
class logits + sigmoid boxes.  Layers are per-layer modules (the JAX
package stacks them on a leading axis for ``scan``); the matcher and the
loss arrive with the training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import msda as msda_mod
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers

NUM_QUERIES = 300


class EncoderLayer(nn.Module):
    def __init__(self, gen, cfg):
        super().__init__()
        self.norm1 = layers.init_norm(cfg)
        self.msda = msda_mod.init_msda_attention(gen, cfg.d_model, cfg.msda)
        self.norm2 = layers.init_norm(cfg)
        self.mlp = layers.init_mlp(gen, cfg)


class DecoderLayer(nn.Module):
    def __init__(self, gen, cfg):
        super().__init__()
        self.norm1 = layers.init_norm(cfg)
        self.self_attn = attention.init_attention(gen, cfg)
        self.norm2 = layers.init_norm(cfg)
        self.msda = msda_mod.init_msda_attention(gen, cfg.d_model, cfg.msda)
        self.norm3 = layers.init_norm(cfg)
        self.mlp = layers.init_mlp(gen, cfg)


class DeformableDETR(nn.Module):
    """Parameter tree of ``init_detr``; ``state_dict`` keys are the JAX
    pytree paths with the layer index after ``enc_layers`` / ``dec_layers``.
    ``gen=None`` allocates without initialising (for loading weights)."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        d, L = cfg.d_model, len(cfg.msda.levels)
        self.level_emb = nn.Parameter(layers.embed_init(gen, (L, d), 0.02))
        self.enc_layers = nn.ModuleList(EncoderLayer(gen, cfg) for _ in range(cfg.num_layers))
        self.query_emb = nn.Parameter(layers.embed_init(gen, (NUM_QUERIES, d), 0.02))
        self.ref_head = layers.init_linear(gen, d, 2)
        self.dec_layers = nn.ModuleList(DecoderLayer(gen, cfg) for _ in range(cfg.num_layers))
        self.class_head = layers.init_linear(gen, d, cfg.vocab_size, bias=True)
        self.box_head = nn.ModuleDict({
            "l1": layers.init_linear(gen, d, d, bias=True),
            "l2": layers.init_linear(gen, d, 4, bias=True),
        })
        self.final_norm = layers.init_norm(cfg)


def init_detr(cfg, seed: int = 0, device="cuda") -> DeformableDETR:
    """Random DETR weights from ``seed`` (drawn on the CPU), on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return DeformableDETR(cfg, gen).to(dev)


def msda_plans(cfg, *, dtype="float32"):
    """The model's two MsdaPlans (encoder Q = sum HW, decoder Q = 300)."""
    mc = cfg.msda
    sp = sum(h * w for h, w in mc.levels)
    D = cfg.d_model // mc.num_heads
    enc = msda_mod.attention_plan(mc, num_queries=sp, head_dim=D, dtype=dtype)
    dec = msda_mod.attention_plan(mc, num_queries=NUM_QUERIES, head_dim=D, dtype=dtype)
    return {"encoder": enc, "decoder": dec}


def _level_emb_expanded(params: DeformableDETR, cfg, dtype) -> torch.Tensor:
    parts = [params.level_emb[i].to(dtype).expand(h * w, cfg.d_model)
             for i, (h, w) in enumerate(cfg.msda.levels)]
    return torch.cat(parts, dim=0)


def encode_pyramid(params: DeformableDETR, cfg, pyramid: torch.Tensor) -> torch.Tensor:
    """pyramid: (B, S, d) flattened multi-scale features -> memory (B, S, d)."""
    mc = cfg.msda
    x = pyramid + _level_emb_expanded(params, cfg, pyramid.dtype)[None]
    refs = msda_mod.level_ref_points(mc.levels, device=pyramid.device)[None]
    refs = refs.expand(x.shape[0], *refs.shape[1:])
    for lp in params.enc_layers:
        h = layers.apply_norm(lp.norm1, x, cfg.norm_eps)
        x = x + msda_mod.msda_attention(lp.msda, mc, h, h, refs)
        h2 = layers.apply_norm(lp.norm2, x, cfg.norm_eps)
        x = x + layers.apply_mlp(lp.mlp, cfg, h2)
    return x


def decode_queries(params: DeformableDETR, cfg, memory: torch.Tensor):
    """300 object queries -> (class_logits (B,300,C), boxes (B,300,4))."""
    mc = cfg.msda
    B = memory.shape[0]
    dt = memory.dtype
    q = params.query_emb.to(dt)[None].expand(B, NUM_QUERIES, cfg.d_model)
    # reference points come from the UNBATCHED query embedding (no bias)
    refs = torch.sigmoid(layers.apply_linear(params.ref_head, params.query_emb))
    refs = refs[None].float().expand(B, NUM_QUERIES, 2)
    for lp in params.dec_layers:
        h = layers.apply_norm(lp.norm1, q, cfg.norm_eps)
        q = q + attention.attention_fwd(lp.self_attn, cfg, h)
        h2 = layers.apply_norm(lp.norm2, q, cfg.norm_eps)
        q = q + msda_mod.msda_attention(lp.msda, mc, h2, memory, refs)
        h3 = layers.apply_norm(lp.norm3, q, cfg.norm_eps)
        q = q + layers.apply_mlp(lp.mlp, cfg, h3)
    q = layers.apply_norm(params.final_norm, q, cfg.norm_eps)
    logits = layers.apply_linear(params.class_head, q)
    b = F.gelu(layers.apply_linear(params.box_head["l1"], q), approximate="tanh")
    boxes = torch.sigmoid(layers.apply_linear(params.box_head["l2"], b))
    return logits, boxes
