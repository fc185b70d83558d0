"""deformable-detr: the paper's own host architecture (copy of
``repro.configs.deformable_detr``).

Six-layer MSDA encoder over a 5-level pyramid from a (stub) Swin
backbone at 1024x1024 input — the exact workload of the paper's
evaluation (sum HW = 87296, d=256, 8 heads, 4 points) — plus a 6-layer
deformable decoder with 300 object queries.
"""
from repro_torch.configs.base import MSDAConfig, ModelConfig, register

PAPER_LEVELS = ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16))

CONFIG = register(ModelConfig(
    name="deformable-detr",
    family="vision",
    num_layers=6,            # encoder layers (decoder mirrors with 6)
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    d_ff=1024,
    vocab_size=91,           # COCO classes as the 'vocab' (detection head)
    head_dim=32,
    gated_mlp=False,
    act="gelu",
    norm_type="layernorm",
    msda=MSDAConfig(levels=PAPER_LEVELS, num_points=4, num_heads=8, backend="auto"),
    source="arXiv:2010.04159 (Deformable DETR) + paper §3 input spec",
))
