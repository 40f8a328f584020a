"""Carry the JAX package's weights into the port.

Input is the JAX params as numpy pytrees — ``jax.tree.map(np.asarray,
params)`` of ``models/mmbidaf.py::mmbidaf_init`` and of
``data/frontend.py::frontend_init`` — never jax arrays, so this module needs
no JAX. The port keeps the JAX layouts (``[in, out]`` linears, gate order
i,f,g,o, summed LSTM bias), so each leaf is a copy to the module parameter
of the same dotted path (``word_lstm.fwd.w_x``; stacked BiLSTMs
``word_lstm.layers.0.fwd.w_x``). The one layout change: VGG conv weights go
from HWIO to the OIHW that ``conv2d`` takes. The audio constants are not
copied: the port rebuilds them with its own numpy code, and loading
refuses a frontend whose constants differ from those. A training state
crosses with ``train_state_from_jax``: params and EMA shadow, with a fresh
optimizer state on the port's side (as the JAX side starts one too).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.data.frontend import Frontend, frontend_init
from mmbidaf_tpu_torch.models.mmbidaf import MMBiDAF, mmbidaf_init
from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC
from mmbidaf_tpu_torch.train.loop import TrainState, init_train_state


def flatten_pytree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts / lists of arrays → ``{"a.b.0.c": array}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_pytree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_pytree(module: torch.nn.Module, tree: Any) -> None:
    """Copy a numpy pytree into ``module`` path by path. Raises on a missing
    or unexpected path and on a shape mismatch (``load_state_dict(strict)``)."""
    flat = flatten_pytree(tree)
    for k, v in flat.items():
        if v.dtype.kind != "f":
            raise TypeError(f"{k}: expected a float array, got {v.dtype}")
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
                           strict=True)


def model_from_jax(params: dict, cfg: Config, device="cuda") -> MMBiDAF:
    """The port's model holding the JAX model's weights."""
    model = mmbidaf_init(cfg, params["embedding"]["table"], device)
    load_pytree(model, params)
    return model


def frontend_from_jax(fe_params: dict, cfg: Config, vgg_spec=VGG16_SPEC, device="cuda") -> Frontend:
    """The port's frontend holding the JAX frontend's VGG weights (HWIO →
    OIHW); its audio constants must equal the port's own."""
    fe = frontend_init(cfg, vgg_spec, device)
    for name, ours in fe.audio_consts.items():
        theirs = np.asarray(fe_params["audio_consts"][name])
        if theirs.shape != tuple(ours.shape) or not np.array_equal(theirs, ours.cpu().numpy()):
            raise ValueError(f"audio constant {name!r} differs from the port's own")
    if ("vgg" in fe_params) != hasattr(fe, "vgg"):
        raise ValueError("the JAX frontend's VGG weights do not match cfg.model.use_images")
    tree = {}
    if "vgg" in fe_params:
        vgg = dict(fe_params["vgg"])
        vgg["convs"] = [{"w": np.asarray(c["w"]).transpose(3, 2, 0, 1), "b": c["b"]}
                        for c in fe_params["vgg"]["convs"]]
        tree["vgg"] = vgg
    load_pytree(fe, tree)
    return fe


def train_state_from_jax(params: dict, ema_params: dict, cfg: Config, device="cuda",
                         seed: int = 0) -> TrainState:
    """A ``TrainState`` holding the JAX run's params and EMA shadow (numpy
    pytrees), with a fresh optimizer state and step 0, and a dropout
    generator seeded with ``seed``."""
    state = init_train_state(model_from_jax(params, cfg, device), cfg, seed)
    load_pytree(state.ema_params, ema_params)
    return state
