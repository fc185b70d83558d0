"""Parity of the PyTorch port's Deformable-DETR inference slice against the
JAX package, on the reduced config (2+2 layers, d_model 64).

Weights are made by the JAX ``init_detr`` and carried over with
``detr_params_from_jax``; inputs come from the detection source, which
both packages compute with the same numpy generator.  The JAX side runs
the Pallas kernels in interpret mode (``backend="pallas"``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import deformable_transformer as jax_dt
from repro.core import msda as jax_msda
from repro.data import pipeline as jax_pipeline
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import deformable_transformer as dt
from repro_torch.core import msda as t_msda
from repro_torch.data import pipeline
from repro_torch.kernels import msda_fwd
from repro_torch.models import attention, layers

# The slice stacks 2 encoder + 2 decoder layers over the fused MSDA, whose
# per-call error is within FWD_TOL (2e-5); residual adds and layernorms
# carry it through, so end-to-end outputs are held to 1e-4.
SLICE_TOL = 1e-4


def _cfgs(backend="pallas"):
    jcfg = jax_reduced(jax_get_config("deformable-detr"))
    jcfg = dataclasses.replace(jcfg, msda=dataclasses.replace(jcfg.msda, backend=backend))
    return jcfg, reduced(get_config("deformable-detr"))


def _jax_params(jcfg, seed=0, offset_noise=0.5):
    """JAX init with perturbed w_offsets (the init zeroes them, which keeps
    every sample on the bias ring and never reaches a border)."""
    params = jax.tree.map(np.asarray, jax_dt.init_detr(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    for stack in ("enc_layers", "dec_layers"):
        w = params[stack]["msda"]["w_offsets"]
        params[stack]["msda"]["w_offsets"] = (
            rng.standard_normal(w.shape) * offset_noise).astype(np.float32)
    return params


def _batch(cfg, step=0, B=2):
    dc = jax_pipeline.DataConfig(global_batch=B, seq_len=0, vocab_size=cfg.vocab_size,
                                 source="detection", levels=cfg.msda.levels,
                                 feat_dim=cfg.d_model)
    return jax_pipeline._detection_batch(dc, step)


def test_configs_match_jax():
    jcfg, tcfg = _cfgs(backend="auto")
    for full in (False, True):
        j = jax_get_config("deformable-detr") if full else jcfg
        t = get_config("deformable-detr") if full else tcfg
        for f in dataclasses.fields(t):
            if f.name != "msda":  # another class on each side: compared below
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        # the port's MSDAConfig keeps a subset of the JAX fields
        for f in dataclasses.fields(t.msda):
            assert getattr(t.msda, f.name) == getattr(j.msda, f.name), f.name


def test_detection_batch_matches_jax():
    jcfg, tcfg = _cfgs()
    want = _batch(jcfg, step=3)
    dc = pipeline.DataConfig(global_batch=2, seq_len=0, vocab_size=tcfg.vocab_size,
                             levels=tcfg.msda.levels, feat_dim=tcfg.d_model)
    got = pipeline.detection_batch(dc, 3, device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_layers_match_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jn = {"scale": rng.standard_normal(jcfg.d_model).astype(np.float32),
          "bias": rng.standard_normal(jcfg.d_model).astype(np.float32)}
    tn = layers.init_norm(tcfg)
    tn.load_state_dict({k: torch.tensor(v) for k, v in jn.items()})
    jm = jax.tree.map(np.asarray, jax_layers.init_mlp(jax.random.PRNGKey(2), jcfg))
    tm = layers.init_mlp(None, tcfg)
    tm.load_state_dict({k: torch.tensor(v) for k, v in jm.items()})
    tx = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(layers.apply_norm(tn, tx, tcfg.norm_eps).numpy(),
                                   np.asarray(jax_layers.apply_norm(jn, jnp.asarray(x))),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(layers.apply_mlp(tm, tcfg, tx).numpy(),
                                   np.asarray(jax_layers.apply_mlp(jm, jcfg, jnp.asarray(x))),
                                   atol=1e-5, rtol=1e-5)


def test_self_attention_matches_jax():
    """GQA (4 query heads over 2 kv heads in the reduced config)."""
    jcfg, tcfg = _cfgs()
    assert jcfg.num_heads != jcfg.num_kv_heads
    jp = jax.tree.map(np.asarray, jax_attention.init_attention(jax.random.PRNGKey(3), jcfg))
    tp = attention.init_attention(None, tcfg)
    tp.load_state_dict({k: torch.tensor(v) for k, v in jp.items()})
    x = np.random.default_rng(4).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    want = jax_attention.attention_fwd(jp, jcfg, jnp.asarray(x), causal=False, rope=False)
    with torch.no_grad():
        got = attention.attention_fwd(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_level_ref_points_and_msda_init_match_jax():
    levels = ((2, 3), (1, 1))
    np.testing.assert_array_equal(t_msda.level_ref_points(levels, device="cpu").numpy(),
                                  np.asarray(jax_msda.level_ref_points(levels)))
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    jb = np.asarray(jax_msda.init_msda_attention(jax.random.PRNGKey(0), 64, jcfg.msda)["b_offsets"])
    tb = t_msda.init_msda_attention(torch.Generator().manual_seed(0), 64, tcfg.msda).b_offsets
    np.testing.assert_allclose(tb.detach().numpy(), jb, atol=1e-6, rtol=0)


def test_convert_splits_stacked_layers():
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg)
    model = convert.detr_params_from_jax(params, tcfg, device="cpu")
    assert len(model.enc_layers) == len(model.dec_layers) == tcfg.num_layers
    np.testing.assert_array_equal(
        model.dec_layers[1].msda.w_offsets.detach().numpy(),
        params["dec_layers"]["msda"]["w_offsets"][1])
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == sum(np.asarray(x).size for x in jax.tree.leaves(params))
    fresh = dt.init_detr(tcfg, seed=0, device="cpu")
    assert fresh.state_dict().keys() == model.state_dict().keys()
    params["extra"] = np.zeros(1, np.float32)
    with pytest.raises(RuntimeError):
        convert.detr_params_from_jax(params, tcfg, device="cpu")


def test_slice_matches_jax_pallas():
    """encode_pyramid memory and decode_queries logits/boxes vs the JAX
    slice with the Pallas fused kernels (interpret mode)."""
    jcfg, tcfg = _cfgs(backend="pallas")
    params = _jax_params(jcfg)
    batch = _batch(jcfg)
    pyr = batch["pyramid"]
    jp = jax.tree.map(jnp.asarray, params)
    jmem = jax_dt.encode_pyramid(jp, jcfg, jnp.asarray(pyr), remat=False)
    jlogits, jboxes = jax_dt.decode_queries(jp, jcfg, jmem)

    model = convert.detr_params_from_jax(params, tcfg, device="cpu")
    with torch.no_grad():
        mem = dt.encode_pyramid(model, tcfg, torch.from_numpy(pyr))
        logits, boxes = dt.decode_queries(model, tcfg, mem)
    assert logits.shape == (2, 300, tcfg.vocab_size) and boxes.shape == (2, 300, 4)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=SLICE_TOL, rtol=SLICE_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=SLICE_TOL, rtol=SLICE_TOL)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), atol=SLICE_TOL, rtol=SLICE_TOL)


def test_slice_cuda_backend_agrees_with_ref_on_cpu():
    """The kernel backend (plain version on CPU) and the oracle backend give
    the same slice; both build one plan per geometry."""
    _, tcfg = _cfgs()
    cfg_ref = dataclasses.replace(tcfg, msda=dataclasses.replace(tcfg.msda, backend="ref"))
    model = dt.init_detr(tcfg, seed=1, device="cpu")
    pyr = torch.from_numpy(_batch(tcfg)["pyramid"])
    before = msda_fwd.msda_fwd_fused.launches
    with torch.no_grad():
        a = dt.decode_queries(model, tcfg, dt.encode_pyramid(model, tcfg, pyr))
        b = dt.decode_queries(model, cfg_ref, dt.encode_pyramid(model, cfg_ref, pyr))
    assert msda_fwd.msda_fwd_fused.launches == before  # CPU: no kernel launch
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=SLICE_TOL, rtol=SLICE_TOL)
    plans = dt.msda_plans(tcfg)
    assert plans["encoder"].launches_per_call() == {"fwd": 1, "bwd": 0}
    assert plans["decoder"].spec.num_queries == 300
