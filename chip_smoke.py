#!/usr/bin/env python3
"""Drive the PyTorch port's Deformable-DETR inference on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100.  Phases, each
fatal on failure (no CPU fallback, nothing caught and passed over):

1. build   — nvcc builds every kernel of the path from ``src/repro_torch/
             kernels/csrc`` (sm_90a); prints the card and the ptxas report.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the encoder (Q = 87296, B = 1 and B = 2) and decoder (Q = 300,
             B = 2) geometries, loc in [-0.1, 1.1]; fp32 FWD_TOL = 2e-5.
             A backward through the kernel and a misaligned operand raise.
3. slice   — full-width Deformable-DETR (6+6 layers, d = 256, 5 levels,
             sum HW = 87296) from ``init_detr(seed)`` answers requests of 2
             pyramids from the detection source; shapes, finiteness, 12
             kernel launches per request, and agreement with backend="ref".
             The operands of the path's first encoder and decoder MSDA
             calls are captured and the kernel is checked on them too.
4. times   — CUDA-event kernel times beside their bound, the plain version
             and the grid_sample baseline, on random and on the path's own
             operands; request latency; peak memory; a torch.profiler
             breakdown of one request by kernel, with the device idle share.

Prints a kernel JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no card is present or the repo's sources are missing.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
FWD_TOL = 2e-5  # fp32 forward tolerance of the conformance suite
# The kernel and the oracle sum in different orders (each MSDA call agrees
# within FWD_TOL); 12 residual layers with layernorms at d = 256 carry that
# through, so the slice's outputs are held to 1e-3 absolute and relative —
# 50x the per-call tolerance and far below the logits' and boxes' scale.
SLICE_TOL = 1e-3
# Deformable-DETR initialises w_offsets to zero, which leaves every sample
# on the bias ring; a trained model's offsets depend on the query.  Seeded
# noise of this std (pixels per unit of layernormed query, ~1.6 px at
# d = 256) spreads the samples and sends some across the level borders.
OFFSET_NOISE = 0.1
N_REQUESTS = 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 outside tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/msda_fwd_fused.cu"
KERNEL_REPLACES = "src/repro/kernels/msda_fwd.py:449"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def msda_inputs(gen, B, Q, S, H, D, L, P):
    import torch

    value = torch.randn((B, S, H, D), generator=gen, device="cuda")
    loc = torch.rand((B, Q, H, L, P, 2), generator=gen, device="cuda") * 1.2 - 0.1
    logits = torch.randn((B, Q, H, L * P), generator=gen, device="cuda")
    attn = torch.softmax(logits, -1).reshape(B, Q, H, L, P).contiguous()
    return value, loc, attn


def work_bound(value, loc, attn, levels):
    """Least time for one call: bytes (value rows the samples touch, loc,
    attn, out) over HBM rate vs fp32 operations (2 per valid corner and 2
    for the attention weight, per sample and channel) over the fp32 rate."""
    import torch
    from repro_torch.kernels.msda_fwd import corner_indices

    B, S, H, D = value.shape
    touched = torch.zeros(B * S * H, dtype=torch.bool, device=value.device)
    b_base = (torch.arange(B, device=value.device) * S).view(B, 1, 1, 1)
    h_idx = torch.arange(H, device=value.device).view(1, 1, H, 1)
    valid_corners, start = 0, 0
    for l, (hl, wl) in enumerate(levels):
        x0, y0, _, _, masks = corner_indices(loc[:, :, :, l], hl, wl)
        for (dx, dy), m in zip(((0, 0), (1, 0), (0, 1), (1, 1)), masks):
            rows = (b_base + start + (y0 + dy).clamp(0, hl - 1) * wl
                    + (x0 + dx).clamp(0, wl - 1)) * H + h_idx
            touched[rows[m]] = True
            valid_corners += int(m.sum())
        start += hl * wl
    samples = loc[..., 0].numel()
    out_bytes = loc.shape[0] * loc.shape[1] * H * D * 4
    nbytes = int(touched.sum()) * D * 4 + loc.numel() * 4 + attn.numel() * 4 + out_bytes
    flops = (2 * valid_corners + 2 * samples) * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "flops": flops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def capture_msda_operands(run):
    """(value, loc, attn) of every MSDA kernel call ``run()`` makes, in order.

    Wraps ``ops.msda_fused``, which the cuda backend's executor looks up at
    each call, for the duration of ``run()`` only."""
    from repro_torch.kernels import ops

    calls, real = [], ops.msda_fused

    def record(value, loc, attn, spatial_shapes):
        calls.append((value.contiguous(), loc.contiguous(), attn.contiguous()))
        return real(value, loc, attn, spatial_shapes)

    ops.msda_fused = record
    try:
        run()
    finally:
        ops.msda_fused = real
    return calls


def profile_request(run, card: str, top: int = 8) -> None:
    """Device time of one request by kernel (torch.profiler), and the share
    of the request's wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Device activity only.  The device timeline also carries one annotation
    # per CPU op (aten::mm, FusedForward, ...) spanning the kernels that op
    # launched; those share the op's name and would count the time twice.
    events = prof.events()
    cpu_names = {e.name for e in events if not str(e.device_type).endswith("CUDA")}
    kernels = [e for e in events
               if str(e.device_type).endswith("CUDA") and e.name not in cpu_names]
    busy_us, span = 0.0, None
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if span is None or start > span[1]:
            busy_us += 0.0 if span is None else span[1] - span[0]
            span = [start, end]
        else:
            span[1] = max(span[1], end)
    busy_ms = (busy_us + (0.0 if span is None else span[1] - span[0])) / 1e3
    log(f"[profile] {card} | one request under torch.profiler: wall {wall_ms:.2f} ms, "
        f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%), {len(kernels)} device activities")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[profile]   {t:9.3f} ms {100 * t / busy_ms:5.1f}%  x{n:<4d} {name[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the root of a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.base import get_config
    from repro_torch.core import deformable_transformer as dt
    from repro_torch.data.pipeline import DataConfig, detection_batch
    from repro_torch.kernels import build, msda_fwd, ops, ref

    # -- 1. build ---------------------------------------------------------
    card = card_line()
    log(f"[card] {card}")
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build("msda_fwd_fused")
    log(f"[build] msda_fwd_fused ready in {time.perf_counter() - t0:.1f} s; ptxas: "
        + (build.PTXAS_REPORTS.get("msda_fwd_fused") or "(library already built)"))

    cfg = get_config("deformable-detr")
    mc = cfg.msda
    levels = mc.levels
    S = sum(h * w for h, w in levels)
    H, P, L = mc.num_heads, mc.num_points, len(levels)
    D = cfg.d_model // H

    # -- 2. kernel vs plain version on the card --------------------------
    operands, errs = {}, {}

    def check_kernel(name, ops_):
        got = msda_fwd.msda_fwd_fused(*ops_, levels)
        torch.cuda.synchronize()
        want = msda_fwd.msda_fwd_fused_plain(*ops_, levels)
        oracle = ref.msda_ref(ops_[0], levels, ops_[1], ops_[2])
        err = float((got - want).abs().max())
        err_ref = float((got - oracle).abs().max())
        B, Q = ops_[1].shape[:2]
        log(f"[kernels] msda_fwd_fused {name} B={B} Q={Q}: max|kernel-plain| = {err:.3e}, "
            f"max|kernel-ref| = {err_ref:.3e} (FWD_TOL {FWD_TOL})")
        if not (err <= FWD_TOL and err_ref <= FWD_TOL):
            fail(f"msda_fwd_fused disagrees at {name}: {err} / {err_ref} > {FWD_TOL}")
        operands[name], errs[name] = ops_, err

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    geoms = {"random_encoder_b1": (1, S), "random_encoder_b2": (2, S),
             "random_decoder_b2": (2, dt.NUM_QUERIES)}
    for name, (B, Q) in geoms.items():
        check_kernel(name, msda_inputs(gen, B, Q, S, H, D, L, P))
    log(f"[kernels] ported: msda_fwd_fused (replaces {KERNEL_REPLACES}) — PASS at random "
        f"operands, max_abs_err {max(errs.values()):.3e} <= {FWD_TOL}")
    # no backward kernel yet: a gradient through the kernel must raise
    small = [t.requires_grad_() for t in msda_inputs(gen, 1, 8, S, H, D, L, P)]
    try:
        ops.msda_fused(*small, levels).sum().backward()
        fail("backward through the CUDA kernel returned instead of raising")
    except NotImplementedError as err:
        log(f"[kernels] backward on the card raises as it must: {err}")
    # a contiguous view off the kernel's vector alignment must raise before
    # any launch (a misaligned float4 load would poison the CUDA context)
    value, loc, attn = (t.detach() for t in small)
    for name, (v, lc) in {
            "value": (torch.empty(value.numel() + 1, device="cuda")[1:].view(value.shape), loc),
            "loc": (value, torch.empty(loc.numel() + 1, device="cuda")[1:].view(loc.shape)),
    }.items():
        before = msda_fwd.msda_fwd_fused.launches
        try:
            msda_fwd.msda_fwd_fused(v, lc, attn, levels)
            fail(f"a misaligned {name} was launched instead of raising")
        except ValueError as err:
            if msda_fwd.msda_fwd_fused.launches != before:
                fail(f"a misaligned {name} counted a launch")
            log(f"[kernels] misaligned {name} raises as it must: {err}")
    torch.cuda.synchronize()  # the context is still healthy

    # -- 3. the slice -----------------------------------------------------
    model = dt.init_detr(cfg, seed=SEED, device="cuda")
    noise = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for layer in [*model.enc_layers, *model.dec_layers]:
            w = layer.msda.w_offsets
            w.copy_(torch.randn(w.shape, generator=noise) * OFFSET_NOISE)
    cfg_ref = dataclasses.replace(cfg, msda=dataclasses.replace(mc, backend="ref"))
    dc = DataConfig(global_batch=2, seq_len=0, vocab_size=cfg.vocab_size, seed=SEED,
                    levels=levels, feat_dim=cfg.d_model)
    batches = [detection_batch(dc, step, device="cuda") for step in range(N_REQUESTS)]

    def answer(c, pyramid):
        with torch.no_grad():
            memory = dt.encode_pyramid(model, c, pyramid)
            logits, boxes = dt.decode_queries(model, c, memory)
        return memory, logits, boxes

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies, outputs, per_request = [], [], []
    msda_fwd.msda_fwd_fused.launches = 0
    for batch in batches:
        before = msda_fwd.msda_fwd_fused.launches
        t0 = time.perf_counter()
        outputs.append(answer(cfg, batch["pyramid"]))
        torch.cuda.synchronize()
        latencies.append(1e3 * (time.perf_counter() - t0))
        per_request.append(msda_fwd.msda_fwd_fused.launches - before)
    launches = msda_fwd.msda_fwd_fused.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[slice] {N_REQUESTS} requests of B=2: msda_fwd_fused launches per request "
        f"{per_request} (total {launches})")
    if per_request != [12] * N_REQUESTS:
        fail(f"expected 12 kernel launches per request, got {per_request}")

    worst = 0.0
    for i, (batch, (mem, logits, boxes)) in enumerate(zip(batches, outputs)):
        if tuple(logits.shape) != (2, 300, cfg.vocab_size) or tuple(boxes.shape) != (2, 300, 4):
            fail(f"request {i}: shapes {tuple(logits.shape)} {tuple(boxes.shape)}")
        if not all(bool(torch.isfinite(t).all()) for t in (mem, logits, boxes)):
            fail(f"request {i}: non-finite outputs")
        rmem, rlogits, rboxes = answer(cfg_ref, batch["pyramid"])
        for name, a, b in (("memory", mem, rmem), ("logits", logits, rlogits),
                           ("boxes", boxes, rboxes)):
            diff = float((a - b).abs().max())
            worst = max(worst, diff)
            if not torch.allclose(a, b, atol=SLICE_TOL, rtol=SLICE_TOL):
                fail(f"request {i}: {name} differs from backend='ref' by {diff:.3e}")
        del rmem, rlogits, rboxes
    log(f"[slice] outputs finite, shapes (2,300,{cfg.vocab_size}) + (2,300,4); "
        f"max |cuda - ref| over memory/logits/boxes = {worst:.3e} (tol {SLICE_TOL})")

    # the main path's own operands (samples near their reference points,
    # unlike uniform random loc): first encoder and first decoder call
    calls = capture_msda_operands(lambda: answer(cfg, batches[0]["pyramid"]))
    if len(calls) != 12:
        fail(f"expected 12 MSDA calls per request, captured {len(calls)}")
    check_kernel("path_encoder_b2", calls[0])
    check_kernel("path_decoder_b2", calls[6])
    del calls
    max_err = max(errs.values())

    # -- 4. times -----------------------------------------------------------
    timing = {}
    for name, ops_ in operands.items():
        k_ms = cuda_ms(lambda: msda_fwd.msda_fwd_fused(*ops_, levels), iters=20)
        p_ms = cuda_ms(lambda: msda_fwd.msda_fwd_fused_plain(*ops_, levels), iters=3, warmup=1)
        g_ms = cuda_ms(lambda: ref.msda_grid_sample_baseline(ops_[0], levels, ops_[1], ops_[2]),
                       iters=3, warmup=1)
        bound = work_bound(*ops_, levels)
        timing[name] = {"ms": k_ms, "plain_ms": p_ms, "grid_sample_baseline_ms": g_ms,
                        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                        "bytes": bound["bytes"], "flops": bound["flops"],
                        "max_abs_err": errs[name]}
        log(f"[times] {card} | msda_fwd_fused {name}: kernel {k_ms:.4f} ms, bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: {bound['bytes']} B, "
            f"{bound['flops']} FLOP), plain {p_ms:.3f} ms, grid_sample baseline {g_ms:.3f} ms")
    steady = sorted(latencies[1:])[len(latencies[1:]) // 2]
    log(f"[times] {card} | request latency (B=2, host clock to synchronize) ms: "
        + ", ".join(f"{x:.2f}" for x in latencies)
        + f" (first is cold; median of the rest {steady:.2f}); peak memory {peak_gib:.2f} GiB")
    profile_request(lambda: answer(cfg, batches[1]["pyramid"]), card)

    main_geom = timing["path_encoder_b2"]
    line = {"kernels": [{
        "name": "msda_fwd_fused", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": main_geom["ms"], "plain_ms": main_geom["plain_ms"],
        "bound_ms": main_geom["bound_ms"], "bound_by": main_geom["bound_by"],
        "library_ms": None,
        "grid_sample_baseline_ms": main_geom["grid_sample_baseline_ms"],
        "geometries": timing,
        "request_ms": latencies, "peak_memory_gib": peak_gib}]}
    log(json.dumps(line))
    log(f"[card] {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
