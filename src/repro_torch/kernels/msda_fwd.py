"""Fused whole-pyramid MSDA forward: the CUDA kernel and its plain version.

Port of ``repro.kernels.msda_fwd.msda_fwd_fused`` in inference mode (no
saved corners).  :func:`msda_fwd_fused` is the wrapper: on a CUDA tensor
it launches ``csrc/msda_fwd_fused.cu`` (and counts the launch in
``msda_fwd_fused.launches``) or raises; on a CPU tensor it runs
:func:`msda_fwd_fused_plain`, the same arithmetic in PyTorch.  Operands
stay in the public layout: value (B,S,H,D), loc (B,Q,H,L,P,2), attn
(B,Q,H,L,P) -> (B,Q,H*D).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

Shapes = Tuple[Tuple[int, int], ...]

# the kernel's LevelTable capacity (csrc/msda_fwd_fused.cu kMaxLevels)
MAX_LEVELS = 8


def corner_indices(loc: torch.Tensor, H: int, W: int):
    """Bilinear corner bookkeeping of the kernel for one level.

    loc: (..., 2) fp32 (x, y), grid_sample(align_corners=False).  Returns
    ``(x0, y0, lx, ly, masks)``: the integer top-left corner in the
    level's own (unpadded) pixel grid, the fractional offsets, and the
    validity of corners (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1).  The
    JAX kernel's padded index is ``(clip(y0,-1,H-1)+1)*(W+2) +
    clip(x0,-1,W-1)+1`` with the same masks.
    """
    px = loc[..., 0] * W - 0.5
    py = loc[..., 1] * H - 0.5
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    lx = px - x0f
    ly = py - y0f
    # floor first: truncation toward zero is wrong for px < 0; the clamp
    # mirrors the kernel's (it changes no validity decision)
    x0 = x0f.clamp(-2, W).to(torch.int64)
    y0 = y0f.clamp(-2, H).to(torch.int64)
    vx0 = (x0 >= 0) & (x0 < W)
    vx1 = (x0 + 1 >= 0) & (x0 + 1 < W)
    vy0 = (y0 >= 0) & (y0 < H)
    vy1 = (y0 + 1 >= 0) & (y0 + 1 < H)
    return x0, y0, lx, ly, (vx0 & vy0, vx1 & vy0, vx0 & vy1, vx1 & vy1)


def _check_shapes(value, loc, attn, spatial_shapes: Shapes) -> None:
    if value.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError(
            f"expected value (B,S,H,D), loc (B,Q,H,L,P,2), attn (B,Q,H,L,P); got "
            f"{tuple(value.shape)}, {tuple(loc.shape)}, {tuple(attn.shape)}")
    B, S, H, _ = value.shape
    _, Q, _, L, P, _ = loc.shape
    if S != sum(h * w for h, w in spatial_shapes) or L != len(spatial_shapes):
        raise ValueError(f"value S={S} / loc L={L} do not match levels {spatial_shapes}")
    if tuple(loc.shape) != (B, Q, H, L, P, 2) or tuple(attn.shape) != (B, Q, H, L, P):
        raise ValueError(
            f"loc {tuple(loc.shape)} / attn {tuple(attn.shape)} do not match "
            f"value {tuple(value.shape)}")
    if not (value.device == loc.device == attn.device):
        raise ValueError("value, loc and attn must lie on one device")


def msda_fwd_fused_plain(value: torch.Tensor, loc: torch.Tensor, attn: torch.Tensor,
                         spatial_shapes: Shapes) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: masked corners, a per-level fp32
    partial, and the ordered level fold.  Loops over levels, so memory
    stays at one level's corners (not all L levels' at once)."""
    _check_shapes(value, loc, attn, spatial_shapes)
    B, S, H, D = value.shape
    Q = loc.shape[1]
    rows = value.float().reshape(B * S * H, D)
    loc = loc.float()
    attn = attn.float()
    dev = value.device
    b_base = (torch.arange(B, device=dev) * S).view(B, 1, 1, 1)
    h_idx = torch.arange(H, device=dev).view(1, 1, H, 1)
    out = torch.zeros((B, Q, H, D), dtype=torch.float32, device=dev)
    start = 0
    for l, (Hl, Wl) in enumerate(spatial_shapes):
        x0, y0, lx, ly, (m00, m10, m01, m11) = corner_indices(loc[:, :, :, l], Hl, Wl)

        def corner(xi, yi, m, w):
            pix = start + yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)
            return rows[(b_base + pix) * H + h_idx] * (w * m)[..., None]

        sampled = (corner(x0, y0, m00, (1 - lx) * (1 - ly))
                   + corner(x0 + 1, y0, m10, lx * (1 - ly))
                   + corner(x0, y0 + 1, m01, (1 - lx) * ly)
                   + corner(x0 + 1, y0 + 1, m11, lx * ly))  # (B,Q,H,P,D)
        partial = (sampled * attn[:, :, :, l, :, None]).sum(3)  # (B,Q,H,D)
        out = out + partial
        start += Hl * Wl
    return out.reshape(B, Q, H * D)


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load("msda_fwd_fused")
        p = ctypes.c_void_p
        i64 = ctypes.c_longlong
        i32 = ctypes.c_int
        lib.msda_fwd_fused_launch.argtypes = [p, p, p, p, i64, i64, i64, i32, i32,
                                              i32, i32, p, p, p]
        lib.msda_fwd_fused_launch.restype = ctypes.c_int
        lib.msda_error_string.argtypes = [ctypes.c_int]
        lib.msda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_kernel_operands(value: torch.Tensor, loc: torch.Tensor, attn: torch.Tensor) -> None:
    """Raise unless the kernel can read these operands as they lie.

    Contiguous fp32, ``D % 32 == 0``, at most ``MAX_LEVELS`` levels, and
    the kernel's vector loads aligned: value is read as float4 (its base
    on 16 bytes; ``D % 32`` keeps every row so) and loc as float2 (8
    bytes).  A view with a storage offset can break either; the card
    would then fault with a misaligned address that poisons the context.
    """
    for name, t in (("value", value), ("loc", loc), ("attn", attn)):
        if t.dtype != torch.float32:
            raise TypeError(f"msda_fwd_fused: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"msda_fwd_fused: {name} must be contiguous")
    D, L = value.shape[3], loc.shape[3]
    if D % 32 or L > MAX_LEVELS:
        raise ValueError(f"msda_fwd_fused: needs D % 32 == 0 and L <= {MAX_LEVELS}; "
                         f"got D={D}, L={L}")
    for name, t, align in (("value", value, 16), ("loc", loc, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"msda_fwd_fused: {name} must start on a {align}-byte "
                             f"boundary (storage offset {t.storage_offset()})")


def msda_fwd_fused(value: torch.Tensor, loc: torch.Tensor, attn: torch.Tensor,
                   spatial_shapes: Shapes) -> torch.Tensor:
    """Fused whole-pyramid forward: one kernel launch for all levels.

    CPU tensors run :func:`msda_fwd_fused_plain`.  CUDA tensors must pass
    :func:`check_kernel_operands`; anything else raises — there is no
    fallback on the card.
    """
    _check_shapes(value, loc, attn, spatial_shapes)
    if value.device.type == "cpu":
        return msda_fwd_fused_plain(value, loc, attn, spatial_shapes)
    if value.device.type != "cuda":
        raise ValueError(f"msda_fwd_fused: unsupported device {value.device}")
    check_kernel_operands(value, loc, attn)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out
    hw = (ctypes.c_int * (2 * L))(*[v for hw_l in spatial_shapes for v in hw_l])
    starts, s0 = [], 0
    for h, w in spatial_shapes:
        starts.append(s0)
        s0 += h * w
    st = (ctypes.c_longlong * L)(*starts)
    lib = _kernel_lib()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = lib.msda_fwd_fused_launch(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            B, S, Q, H, D, L, P, ctypes.addressof(hw), ctypes.addressof(st), stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd_fused launch failed: "
                           f"{lib.msda_error_string(rc).decode()} ({rc})")
    msda_fwd_fused.launches += 1
    return out


msda_fwd_fused.launches = 0
