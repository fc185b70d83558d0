"""MSDA backend registry: name -> executor builder (port of
``repro.kernels.registry``).

Builder protocol::

    def builder(spec: MsdaSpec, tuning: PlanTuning) -> Callable:
        ...  # returns exec(value, loc, attn) -> (B, Q, H*D)

Built-in backends (registered by ``repro_torch.kernels.plan``):

* ``"ref"``  — the plain PyTorch oracle (``kernels/ref.py``).
* ``"cuda"`` — the hand-written kernels: the CUDA kernel for CUDA
  tensors, its plain version for CPU tensors.

``"auto"`` is reserved and resolves to ``"cuda"``.
"""
from __future__ import annotations

from typing import Callable, Dict

BackendBuilder = Callable  # (spec, tuning) -> executor

_BACKENDS: Dict[str, BackendBuilder] = {}
_RESERVED = ("auto",)


class UnknownBackendError(ValueError):
    """Raised when a plan names a backend nobody registered."""


def backend(name: str):
    """Decorator registering a builder under ``name``."""
    if name in _RESERVED:
        raise ValueError(f"backend name {name!r} is reserved")
    if name in _BACKENDS:
        raise ValueError(f"backend {name!r} already registered")

    def deco(builder: BackendBuilder) -> BackendBuilder:
        _BACKENDS[name] = builder
        return builder

    return deco


def resolve_backend(name: str) -> str:
    """``"auto"`` -> ``"cuda"``; any other name is returned unchanged."""
    return "cuda" if name == "auto" else name


def get_backend(name: str) -> BackendBuilder:
    _ensure_defaults()
    name = resolve_backend(name)
    try:
        return _BACKENDS[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown MSDA backend {name!r}; registered: {sorted(_BACKENDS)}") from None


def _ensure_defaults() -> None:
    if not {"ref", "cuda"} <= set(_BACKENDS):
        import repro_torch.kernels.plan  # noqa: F401  (registers on import)
