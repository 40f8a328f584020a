"""The one traffic generator: a pool of batches made on the device from the
seed, by the parameters of a mix file (``port_bench/traffic/<mix>.json``).

A mix names its program kind (``program``), whose file
(``port_bench/programs/<kind>.py``) makes one batch from the mix's
parameters; the pool is ``pool`` such batches in turn from one generator.
Every seed gives batches of the same shapes; only the values move.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 60-bit seed for one use of ``--seed`` (any size of integer)."""
    return int(hashlib.sha256(f"{seed}:{purpose}".encode()).hexdigest()[:15], 16)


def pool(cfg: dict, mix: dict, seed: int, device) -> list[dict]:
    """``mix["pool"]`` distinct batches of the mix's program kind, from ``seed``."""
    from pbench import spec

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic"))
    make = spec.program(mix["program"]).make_batch
    return [make(cfg, mix, gen, device) for _ in range(mix["pool"])]
