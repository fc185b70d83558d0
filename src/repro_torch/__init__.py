"""PyTorch + CUDA port of the MSDA reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its tree
(``configs/``, ``data/``, ``kernels/``, ``models/``, ``core/``) so every
module has a counterpart of the same name.  It imports ``torch``, numpy
and the standard library only.  Entry points that create tensors default
to ``device="cuda"`` and raise when no card is present unless the caller
passes ``device="cpu"``.
"""
