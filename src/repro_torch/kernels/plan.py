"""MSDA plan/execute API: the subset of ``repro.kernels.plan`` the
Deformable-DETR inference path uses.

``msda_plan(spec, backend=...)`` resolves the backend once per static
geometry and caches the executable :class:`MsdaPlan` in a bounded LRU.
The ``"cuda"`` backend always commits the whole-pyramid fused tier: one
kernel launch per forward call.  What the TPU planner does besides —
VMEM budgets, block planning, autotune, sharding, sparsity, prefix tiers,
the fallback ladder — is not ported yet, and a spec that asks for it
raises :class:`NotImplementedError` rather than running something else.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import registry

Shapes = Tuple[Tuple[int, int], ...]


def dtype_name(dtype) -> str:
    """'float32' for torch.float32, 'float32', numpy dtypes, ..."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(getattr(dtype, "name", dtype))


@dataclass(frozen=True)
class MsdaSpec:
    """Static geometry of one MSDA problem (hashable; the plan-cache key).

    Same fields and defaults as ``repro.kernels.plan.MsdaSpec`` so specs
    compare across packages.  ``vmem_budget`` is a TPU quantity: it is
    carried, never resolved or read.
    """

    spatial_shapes: Shapes
    num_heads: int
    head_dim: int
    num_points: int
    num_queries: int
    dtype: str = "float32"
    train: bool = False
    vmem_budget: int = 0
    fuse_gather: bool = True
    fuse_scatter: bool = True
    adaptive_block: bool = True
    onehot_small_levels: bool = False
    slab_dtype: str = ""
    accum_dtype: str = "float32"
    fuse_levels: str = "auto"
    sparsity: str = "off"
    sparsity_k: int = 0
    query_order: str = "identity"

    def __post_init__(self):
        shapes = tuple((int(h), int(w)) for h, w in self.spatial_shapes)
        object.__setattr__(self, "spatial_shapes", shapes)
        object.__setattr__(self, "dtype", dtype_name(self.dtype))
        if self.slab_dtype not in ("", "auto"):
            object.__setattr__(self, "slab_dtype", dtype_name(self.slab_dtype))
        object.__setattr__(self, "accum_dtype", dtype_name(self.accum_dtype))

    @property
    def num_levels(self) -> int:
        return len(self.spatial_shapes)

    @property
    def total_pixels(self) -> int:
        return sum(h * w for h, w in self.spatial_shapes)

    def resolved_slab_dtype(self) -> str:
        """The slab storage dtype ('' and 'auto' follow the operand)."""
        if self.slab_dtype in ("", "auto"):
            return self.dtype
        return self.slab_dtype


@dataclass(frozen=True)
class PlanTuning:
    """Resolved per-plan decisions handed to the backend builder."""

    # True: one fused launch over the whole pyramid per direction
    fuse_levels: bool = False


def _check_cuda_spec(spec: MsdaSpec) -> None:
    """Raise for what the fused CUDA tier of this port cannot run."""
    unported = []
    if spec.dtype != "float32" or spec.resolved_slab_dtype() != "float32":
        unported.append(f"dtype={spec.dtype}/slab={spec.slab_dtype or 'follow'} "
                        "(fp32 only)")
    if spec.accum_dtype != "float32":
        unported.append(f"accum_dtype={spec.accum_dtype}")
    if spec.fuse_levels not in ("auto", "on"):
        unported.append(f"fuse_levels={spec.fuse_levels} (per-level/prefix tiers)")
    if spec.sparsity != "off":
        unported.append(f"sparsity={spec.sparsity}")
    if spec.query_order != "identity":
        unported.append(f"query_order={spec.query_order}")
    if spec.onehot_small_levels:
        unported.append("onehot_small_levels")
    if not (spec.fuse_gather and spec.fuse_scatter):
        unported.append("fuse_gather/fuse_scatter ablations")
    if spec.head_dim % 32:
        unported.append(f"head_dim={spec.head_dim} (needs a multiple of 32)")
    if unported:
        raise NotImplementedError(
            "the cuda MSDA backend does not run " + ", ".join(unported) + " yet")


@registry.backend("ref")
def _build_ref(spec: MsdaSpec, tuning: PlanTuning) -> Callable:
    """Plain PyTorch oracle; tuning is irrelevant."""
    from repro_torch.kernels import ref

    shapes = spec.spatial_shapes

    def run(value, loc, attn):
        return ref.msda_ref(value, shapes, loc, attn)

    return run


@registry.backend("cuda")
def _build_cuda(spec: MsdaSpec, tuning: PlanTuning) -> Callable:
    """The fused CUDA forward (plain version on CPU tensors)."""
    from repro_torch.kernels import ops

    _check_cuda_spec(spec)
    shapes = spec.spatial_shapes

    def run(value, loc, attn):
        return ops.msda_fused(value, loc, attn, shapes)

    return run


@dataclass(frozen=True)
class MsdaPlan:
    """Executable MSDA plan: ``plan(value, loc, attn) -> (B, Q, H*D)``."""

    spec: MsdaSpec
    backend: str
    tuning: PlanTuning
    _exec: Callable = dataclasses.field(repr=False, compare=False)

    def __call__(self, value: torch.Tensor, sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> torch.Tensor:
        s = self.spec
        if value.shape[1] != s.total_pixels or value.shape[3] != s.head_dim:
            raise ValueError(
                f"value {tuple(value.shape)} does not match plan spec "
                f"(S={s.total_pixels}, D={s.head_dim})")
        if sampling_locations.shape[1] != s.num_queries:
            raise ValueError(
                f"loc Q={sampling_locations.shape[1]} != spec Q={s.num_queries}")
        return self._exec(value, sampling_locations, attention_weights)

    def launches_per_call(self) -> Dict[str, int]:
        """Kernel launches per plan call, by direction: the fused CUDA
        forward launches once; the oracle launches none of the port's
        kernels; no backward kernel is ported yet."""
        return {"fwd": 1 if self.backend == "cuda" else 0, "bwd": 0}

    def describe(self) -> str:
        s = self.spec
        lp = self.launches_per_call()
        fuse = "pyramid" if self.tuning.fuse_levels else "none"
        return (
            f"MsdaPlan(backend={self.backend}, "
            f"fuse={fuse}, train={s.train}, dtype={s.dtype}, accum={s.accum_dtype})\n"
            f"  Q={s.num_queries} H={s.num_heads} D={s.head_dim} P={s.num_points} "
            f"levels={s.num_levels} S={s.total_pixels} "
            f"hw={'/'.join('%dx%d' % hw for hw in s.spatial_shapes)}\n"
            f"  launches/call: fwd={lp['fwd']} bwd={lp['bwd']}")


_PLAN_CACHE: "OrderedDict[tuple, MsdaPlan]" = OrderedDict()
_PLAN_CACHE_MAX = 128


def msda_plan(spec: MsdaSpec, *, backend: str = "auto") -> MsdaPlan:
    """Resolve backend + tuning for ``spec``; cached per (spec, backend)."""
    backend_name = registry.resolve_backend(backend)
    key = (spec, backend_name)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_CACHE.move_to_end(key)
        return cached
    builder = registry.get_backend(backend_name)
    tuning = PlanTuning(fuse_levels=backend_name == "cuda")
    plan = MsdaPlan(spec=spec, backend=backend_name, tuning=tuning,
                    _exec=builder(spec, tuning))
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return plan
