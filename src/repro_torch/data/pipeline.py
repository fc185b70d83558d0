"""Deterministic detection batches (copy of the detection source of
``repro.data.pipeline``).

Batches are a pure function of ``(seed, step)``: the numpy generator is
the same as the JAX package's, so both packages see bit-identical
pyramids for the same key.  :func:`detection_batch` moves one onto a
device as torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    source: str = "detection"
    path: Optional[str] = None
    # detection-source geometry (matches the model config's msda levels)
    levels: Tuple[Tuple[int, int], ...] = ()
    feat_dim: int = 0
    num_targets: int = 3


def _detection_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Synthetic detection batch: pyramid + boxes + labels.

    Each object's center pixel (per level) gets a label-dependent one-hot
    bump the MSDA encoder can learn to pool.
    """
    if not cfg.levels or not cfg.feat_dim:
        raise ValueError("detection source needs DataConfig.levels and feat_dim")
    rng = np.random.default_rng((cfg.seed, step, 7))  # distinct LM stream
    B, T, d = cfg.global_batch, cfg.num_targets, cfg.feat_dim
    boxes = rng.uniform(0.2, 0.8, size=(B, T, 4)).astype(np.float32)
    labels = rng.integers(1, cfg.vocab_size, size=(B, T))
    sp = sum(h * w for h, w in cfg.levels)
    pyr = (rng.standard_normal((B, sp, d)) * 0.05).astype(np.float32)
    offset = 0
    for h, w in cfg.levels:
        cx = np.clip((boxes[..., 0] * w).astype(int), 0, w - 1)
        cy = np.clip((boxes[..., 1] * h).astype(int), 0, h - 1)
        flat = offset + cy * w + cx  # (B,T)
        sig = 2.0 * np.eye(d, dtype=np.float32)[labels % d]
        np.add.at(pyr, (np.arange(B)[:, None], flat), sig)
        offset += h * w
    return {"pyramid": pyr, "labels": labels.astype(np.int32), "boxes": boxes}


def detection_batch(cfg: DataConfig, step: int, device="cuda") -> Dict[str, torch.Tensor]:
    """:func:`_detection_batch` as torch tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in _detection_batch(cfg, step).items()}
