"""Carry weights from the JAX package's pytrees into the port's modules.

The port keeps the JAX layout (``(d_in, d_out)`` applied as ``x @ w``)
and leaf names, so conversion is a rename: nested dict paths become
dotted ``state_dict`` keys, and the JAX package's layer-stacked
``enc_layers`` / ``dec_layers`` leaves (leading axis = layer) are split
into per-layer modules.  Inputs are nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``); this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.deformable_transformer import DeformableDETR
from repro_torch.core.msda import MSDAttention
from repro_torch.device import resolve_device

_STACKED = ("enc_layers", "dec_layers")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def msda_params_from_jax(tree: Mapping, device="cuda") -> MSDAttention:
    """One ``init_msda_attention`` dict -> :class:`MSDAttention`."""
    dev = resolve_device(device)
    return MSDAttention(**{k: _tensor(v) for k, v in tree.items()}).to(dev)


def detr_params_from_jax(tree: Mapping, cfg, device="cuda") -> DeformableDETR:
    """The JAX ``init_detr(key, cfg)`` pytree -> :class:`DeformableDETR`.

    Every leaf must land on a parameter of the port and every parameter
    must be given (strict load), so a renamed leaf fails loudly.
    """
    dev = resolve_device(device)
    state = {}
    for key, leaf in _flatten(tree).items():
        top, _, rest = key.partition(".")
        if top in _STACKED:
            for i in range(leaf.shape[0]):
                state[f"{top}.{i}.{rest}"] = _tensor(leaf[i])
        else:
            state[key] = _tensor(leaf)
    model = DeformableDETR(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(dev)
