"""Parity of the PyTorch port's MSDA kernels and module against the JAX package.

Both sides get the same numpy inputs made from a seed.  Where the JAX side
reaches a Pallas kernel it runs in interpret mode on the CPU; the port's
wrappers run their plain versions because the tensors lie on the CPU.
The CUDA kernel itself is held against its plain version on the card by
``chip_smoke.py`` (the card machine has no JAX, which conftest imports).
"""
import ast
import dataclasses
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import msda as jax_msda
from repro.kernels import msda_fwd as jax_msda_fwd
from repro.kernels import ops as jax_ops
from repro.kernels import plan as jax_plan
from repro.kernels import ref as jax_ref
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import msda as t_msda
from repro_torch.kernels import msda_fwd, ops, plan, ref

# fp32 forward tolerance of the conformance suite (tests/conformance.py:71)
FWD_TOL = 2e-5
REPO = Path(__file__).resolve().parents[1]


def _inputs(seed, levels, B=2, Q=13, H=2, D=32, P=4, lo=-0.1, hi=1.1):
    """value/loc/attn with loc in [lo, hi] so border and out-of-range
    corners are exercised; attn softmaxed over L*P."""
    rng = np.random.default_rng(seed)
    L = len(levels)
    S = sum(h * w for h, w in levels)
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    loc = rng.uniform(lo, hi, (B, Q, H, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, Q, H, L * P)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attn.reshape(B, Q, H, L, P).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", ["msda_ref", "msda_grid_sample_baseline"])
def test_oracles_match_jax(name):
    levels = ((6, 9), (3, 5), (1, 2))
    value, loc, attn = _inputs(0, levels)
    want = getattr(jax_ref, name)(jnp.asarray(value), levels, jnp.asarray(loc), jnp.asarray(attn))
    t_value, t_loc, t_attn = _t(value, loc, attn)
    got = getattr(ref, name)(t_value, levels, t_loc, t_attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 6, 2)).astype(np.float32)
    want = jax_ref.grid_sample(jnp.asarray(x), jnp.asarray(grid))
    got = ref.grid_sample(torch.from_numpy(x), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)


def test_corner_indices_match_jax():
    """Same fractions and masks; the JAX padded index follows from (x0, y0)."""
    rng = np.random.default_rng(2)
    H, W = 5, 7
    loc = rng.uniform(-0.4, 1.4, (64, 2)).astype(np.float32)
    loc[:4] = [[0.0, 0.0], [1.0, 1.0], [-0.5 / W, 0.5], [1 + 0.5 / W, 0.25]]
    idx00, jlx, jly, jmasks = jax_msda_fwd.corner_indices(jnp.asarray(loc), H, W, W + 2)
    x0, y0, lx, ly, masks = msda_fwd.corner_indices(torch.from_numpy(loc), H, W)
    np.testing.assert_array_equal(lx.numpy(), np.asarray(jlx))
    np.testing.assert_array_equal(ly.numpy(), np.asarray(jly))
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    padded = (y0.clamp(-1, H - 1) + 1) * (W + 2) + x0.clamp(-1, W - 1) + 1
    np.testing.assert_array_equal(padded.numpy(), np.asarray(idx00))


def _jax_fused(value, loc, attn, levels):
    """JAX fused whole-pyramid forward, Pallas in interpret mode."""
    L = len(levels)
    Q = loc.shape[1]
    bq = 8 * -(-Q // 8)
    p = jax_ops.MSDAParams(spatial_shapes=levels, block_q=(bq,) * L,
                           fuse_levels=True, interpret=True)
    out, _ = jax_ops._fwd_impl_fused(p, jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    return np.asarray(out)


@pytest.mark.parametrize("levels", [((5, 7),), ((8, 8), (5, 7), (2, 3))],
                         ids=["odd-single", "three-levels"])
@pytest.mark.parametrize("P", [1, 4])
def test_fused_plain_matches_jax_fused(levels, P):
    value, loc, attn = _inputs(3 + P, levels, P=P)
    want = _jax_fused(value, loc, attn, levels)
    got = msda_fwd.msda_fwd_fused_plain(*_t(value, loc, attn), levels)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    levels = ((4, 6), (2, 3))
    value, loc, attn = _t(*_inputs(5, levels))
    before = msda_fwd.msda_fwd_fused.launches
    out = msda_fwd.msda_fwd_fused(value, loc, attn, levels)
    assert msda_fwd.msda_fwd_fused.launches == before
    torch.testing.assert_close(out, msda_fwd.msda_fwd_fused_plain(value, loc, attn, levels),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        msda_fwd.msda_fwd_fused(value[:, :-1], loc, attn, levels)


def _offset_view(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` floats into
    its storage."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("operand,offset", [("value", 1), ("value", 2), ("loc", 1)])
def test_kernel_operands_reject_misaligned_views(operand, offset):
    """The kernel reads value as float4 and loc as float2: a contiguous
    view off those boundaries must be refused before any launch."""
    ops_ = dict(zip(("value", "loc", "attn"), _t(*_inputs(10, ((4, 6), (2, 3)), Q=5))))
    msda_fwd.check_kernel_operands(**ops_)
    ops_[operand] = _offset_view(ops_[operand], offset)
    assert ops_[operand].is_contiguous()
    with pytest.raises(ValueError, match=f"{operand} must start on a"):
        msda_fwd.check_kernel_operands(**ops_)


def test_kernel_operands_reject_what_the_kernel_cannot_read():
    value, loc, attn = _t(*_inputs(11, ((4, 6),), Q=5))
    with pytest.raises(TypeError):
        msda_fwd.check_kernel_operands(value.double(), loc, attn)
    with pytest.raises(ValueError, match="contiguous"):
        msda_fwd.check_kernel_operands(value, loc, attn.transpose(0, 1))
    with pytest.raises(ValueError, match="D % 32"):
        msda_fwd.check_kernel_operands(value[..., :16].contiguous(), loc, attn)


def test_cpu_autograd_through_plain_matches_ref_grads():
    """On CPU tensors ops.msda_fused is the plain version, which autograd
    differentiates; its gradients agree with the oracle's."""
    levels = ((5, 4), (3, 2))
    arrays = _inputs(6, levels, Q=7)
    a = [t.requires_grad_() for t in _t(*arrays)]
    b = [t.requires_grad_() for t in _t(*arrays)]
    gout = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 7, 64)).astype(np.float32))
    (ops.msda_fused(*a, levels) * gout).sum().backward()
    (ref.msda_ref(b[0], levels, b[1], b[2]) * gout).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=5e-4, rtol=0)


def test_spec_fields_match_jax():
    """MsdaSpec keeps the JAX fields and defaults (vmem_budget is resolved
    to a TPU budget on the JAX side only)."""
    kw = dict(spatial_shapes=((8, 8), (4, 4)), num_heads=2, head_dim=32,
              num_points=2, num_queries=80)
    j = jax_plan.spec_to_json(jax_plan.MsdaSpec(**kw))
    t = dataclasses.asdict(plan.MsdaSpec(**kw))
    t["spatial_shapes"] = [list(hw) for hw in t["spatial_shapes"]]
    assert set(j) == set(t)
    j.pop("vmem_budget"), t.pop("vmem_budget")
    assert j == t


@pytest.mark.parametrize("backend,launches", [("ref", 0), ("cuda", 1), ("auto", 1)])
def test_plan_launch_schedule_and_cache(backend, launches):
    spec = plan.MsdaSpec(spatial_shapes=((4, 4),), num_heads=2, head_dim=32,
                         num_points=2, num_queries=5)
    p = plan.msda_plan(spec, backend=backend)
    assert p.launches_per_call() == {"fwd": launches, "bwd": 0}
    assert plan.msda_plan(spec, backend=backend) is p
    assert f"fwd={launches}" in p.describe()
    value, loc, attn = _t(*_inputs(8, ((4, 4),), Q=5, P=2))
    with pytest.raises(ValueError):
        p(value[:, :-1], loc, attn)
    with pytest.raises(ValueError):
        p(value, loc[:, :-1], attn[:, :-1])


def test_plan_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(plan, "_PLAN_CACHE", OrderedDict())
    monkeypatch.setattr(plan, "_PLAN_CACHE_MAX", 2)
    specs = [plan.MsdaSpec(((4, 4),), 2, 32, 2, q) for q in (3, 4, 5)]
    plans = [plan.msda_plan(s, backend="ref") for s in specs]
    assert len(plan._PLAN_CACHE) == 2
    assert plan.msda_plan(specs[2], backend="ref") is plans[2]
    assert plan.msda_plan(specs[0], backend="ref") is not plans[0]  # evicted


@pytest.mark.parametrize("field,value", [
    ("fuse_levels", "off"), ("sparsity", "topk"), ("query_order", "morton"),
    ("dtype", "bfloat16"), ("head_dim", 16)])
def test_cuda_backend_rejects_unported_specs(field, value):
    kw = dict(spatial_shapes=((4, 4),), num_heads=2, head_dim=32, num_points=2,
              num_queries=5)
    kw[field] = value
    with pytest.raises(NotImplementedError):
        plan.msda_plan(plan.MsdaSpec(**kw), backend="cuda")


@pytest.mark.parametrize("valid_ratios", [False, True], ids=["full", "valid_ratios"])
def test_msda_attention_matches_jax(valid_ratios):
    jcfg = jax_reduced(jax_get_config("deformable-detr"))
    mc = jcfg.msda
    tmc = reduced(get_config("deformable-detr")).msda
    d = jcfg.d_model
    rng = np.random.default_rng(9)
    jp = jax.tree.map(np.asarray, jax_msda.init_msda_attention(jax.random.PRNGKey(0), d, mc))
    # the init zeroes w_offsets, which keeps every sample on the bias ring:
    # perturb them so samples spread and cross the borders
    jp["w_offsets"] = (rng.standard_normal(jp["w_offsets"].shape) * 0.5).astype(np.float32)
    S = sum(h * w for h, w in mc.levels)
    B, Q = 2, 11
    query = rng.standard_normal((B, Q, d)).astype(np.float32)
    feats = rng.standard_normal((B, S, d)).astype(np.float32)
    refs = rng.uniform(0, 1, (B, Q, 2)).astype(np.float32)
    vr = rng.uniform(0.5, 1.0, (B, len(mc.levels), 2)).astype(np.float32) if valid_ratios else None
    want = jax_msda.msda_attention(
        jax.tree.map(jnp.asarray, jp), mc, jnp.asarray(query), jnp.asarray(feats),
        jnp.asarray(refs), backend="pallas",
        valid_ratios=None if vr is None else jnp.asarray(vr))
    tp = convert.msda_params_from_jax(jp, device="cpu")
    with torch.no_grad():
        got = t_msda.msda_attention(
            tp, tmc, torch.from_numpy(query), torch.from_numpy(feats), torch.from_numpy(refs),
            valid_ratios=None if vr is None else torch.from_numpy(vr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from repro_torch.core.deformable_transformer import init_detr
    from repro_torch.data.pipeline import DataConfig, detection_batch

    cfg = reduced(get_config("deformable-detr"))
    with pytest.raises(RuntimeError, match="cuda"):
        init_detr(cfg, seed=0)
    dc = DataConfig(global_batch=1, seq_len=0, vocab_size=cfg.vocab_size,
                    levels=cfg.msda.levels, feat_dim=cfg.d_model)
    with pytest.raises(RuntimeError, match="cuda"):
        detection_batch(dc, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        t_msda.level_ref_points(cfg.msda.levels)
