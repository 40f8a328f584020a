"""mmbidaf_tpu_torch — the PyTorch / CUDA port of ``mmbidaf_tpu``.

The JAX package ``mmbidaf_tpu`` stays the reference. This package ports two
of its programs to PyTorch on one NVIDIA GPU: the serving program — raw
video batch → VGG + MFCC frontend → trimodal BiDAF model → sentence-pointer
decode (greedy, top-k or beam) — and training, on feature batches or on a
corpus of raw videos with the frozen frontend inside the step
(``train/loop.py``, ``python -m mmbidaf_tpu_torch.train.cli``), whose runs
``Summarizer.from_run`` serves, ``python -m mmbidaf_tpu_torch.infer`` scores
and ``python -m mmbidaf_tpu_torch.tools.serve`` answers over HTTP. The Pallas
kernels of those paths are rewritten as hand-written CUDA C++ kernels for
Hopper (``sm_90a``) under ``csrc/``.

Layout mirrors the JAX package: ``ops/`` (plain functions on tensors),
``ops/cuda/`` (kernel wrappers, each beside its plain PyTorch version),
``models/`` (``nn.Module`` parameter containers whose names follow the JAX
pytree paths), ``data/``, ``train/``, ``serving.py`` and
``interop/from_jax.py``. The port keeps its own copies of the JAX package's
host-side modules (config, data decoding with the C++ decode runtime of
``native/``, corpus and batching, labels, text, vocab, synthetic data,
benchmarks and subtitles, metrics and ROUGE, the reference-checkpoint
bridge ``interop/torch_port.py``, the corpus tools): it imports neither
``jax`` nor any module of ``mmbidaf_tpu``.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, and raise where there is no card.
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
