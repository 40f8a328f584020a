"""mmbidaf_tpu_torch — the PyTorch / CUDA port of ``mmbidaf_tpu``'s serving path.

The JAX package ``mmbidaf_tpu`` stays the reference. This package ports its
main serving program — raw video batch → VGG + MFCC frontend → trimodal
BiDAF model → greedy sentence-pointer decode — to PyTorch, with the three
Pallas kernels of that path rewritten as hand-written CUDA C++ kernels for
Hopper (``sm_90a``) under ``csrc/``.

Layout mirrors the JAX package: ``ops/`` (plain functions on tensors),
``ops/cuda/`` (kernel wrappers, each beside its plain PyTorch version),
``models/`` (``nn.Module`` parameter containers whose names follow the JAX
pytree paths), ``data/frontend.py``, ``serving.py`` and ``interop/from_jax.py``.
Host-side, JAX-free modules of ``mmbidaf_tpu`` (config, data decoding, text,
vocab, metrics) are imported as they are. Nothing here imports ``jax``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA on a host without a
    usable CUDA device raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but no CUDA device is available"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: expected 'cpu' or 'cuda'")
    return dev
