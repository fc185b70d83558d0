"""Config system: model configs and the registry (copy of ``repro.configs.base``).

Only what the Deformable-DETR slice uses is kept: :class:`MSDAConfig`,
:class:`ModelConfig`, :func:`register` / :func:`get_config` and
:func:`reduced`.  Field names and defaults match the JAX package so a
config built on either side describes the same model.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MSDAConfig:
    """Multi-scale deformable attention config (the paper's op).

    The fields the inference slice reads, with the JAX names and
    defaults.  ``backend`` feeds the plan/execute API
    (``repro_torch.kernels.plan``): ``"auto"`` resolves to the ``"cuda"``
    kernel backend.  The JAX config's tuning, sharding, dtype-policy,
    sparsity and level-fusion knobs arrive with the code that reads them.
    """

    levels: Tuple[Tuple[int, int], ...]
    num_points: int = 4
    num_heads: int = 8
    # kernel backend: 'auto' | 'cuda' | 'ref'
    backend: str = "auto"


FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm", "vision")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (gated) | gelu (dense ff)
    gated_mlp: bool = True
    msda: Optional[MSDAConfig] = None
    dtype: str = "bfloat16"
    max_seq_len: int = 524288
    source: str = ""  # provenance note

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every sibling config module so it registers itself
    import importlib
    import pkgutil

    import repro_torch.configs as pkg

    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name != "base":
            importlib.import_module(f"repro_torch.configs.{m.name}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for single-CPU smoke tests (same widths as
    ``repro.configs.base.reduced`` for the fields this package keeps)."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        dtype="float32",
        max_seq_len=256,
    )
    if cfg.msda is not None:
        kw["msda"] = replace(cfg.msda, levels=((8, 8), (4, 4)), num_points=2, num_heads=2)
    return replace(cfg, **kw)
