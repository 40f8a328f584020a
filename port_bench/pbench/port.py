"""What every program kind (``port_bench/programs/<kind>.py``) shares: the
program's configuration and model built from the benchmark's weights, and
the record of one measured window.

Only the program's entry points are imported, inside the functions:
importing this module loads nothing of ``mmbidaf_tpu_torch``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbench.weights import load_into


def port_config(cfg: dict):
    from mmbidaf_tpu_torch.config import config_from_dict

    return config_from_dict(cfg)


def build_model(pcfg, model_w: dict, device):
    """The program's model holding the benchmark's weights (the GloVe table
    is swapped in whole: it is made here, not by the program)."""
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init

    model = mmbidaf_init(pcfg, np.zeros((1, pcfg.model.emb_dim), np.float32), device, seed=0)
    model.embedding.table = torch.nn.Parameter(torch.empty_like(model_w["embedding.table"]),
                                               requires_grad=False)
    load_into(model, model_w)
    return model


@dataclasses.dataclass
class Window:
    units: int          # batches served or steps taken
    start: float        # perf_counter at the window's start
    wall_s: float       # window start to the closing synchronise
    latencies_s: list   # serving: each batch, dispatch to picks on the host
    outputs: list       # serving: (log_probs on the device, picks on the host) a batch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
