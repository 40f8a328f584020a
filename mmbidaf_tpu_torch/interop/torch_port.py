"""The reference's PyTorch ``state_dict`` straight into the port's
``MMBiDAF`` and back — the port of ``mmbidaf_tpu.interop.torch_port``
(SURVEY.md §4.5, §9).

The port's parameter tree has the JAX package's layout, so the mapping is
the JAX one:

- ``nn.Linear`` stores ``W ∈ [out, in]`` → transposed to the ``x @ W`` layout.
- ``nn.LSTM``: ``weight_ih_l{k} ∈ [4h, in]``, ``weight_hh_l{k} ∈ [4h, h]``,
  two bias vectors that are *summed*; gate block order i, f, g, o (kept, so
  no permutation); the reverse direction in ``*_l{k}_reverse``. The layer
  count is read off the keys: one layer gives the flat ``{fwd, bwd}``, a
  deeper stack ``{"layers": [...]}``.

``port_mmbidaf`` takes numpy arrays or tensors and returns the parameter
tree as numpy arrays; ``model_from_state_dict`` loads it into an
``MMBiDAF``; ``export_mmbidaf`` is the inverse (an ``MMBiDAF`` → a
reference-layout ``dict[str, np.ndarray]``; export then port is the
identity).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.interop.from_jax import load_pytree
from mmbidaf_tpu_torch.models.mmbidaf import MMBiDAF, mmbidaf_init


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def port_linear(sd: Mapping, prefix: str, bias: bool = True) -> dict:
    """``nn.Linear`` → ``{"w": [in, out], "b": [out]}`` (b absent if bias=False)."""
    out = {"w": _np(sd[_key(prefix, "weight")]).T}
    if bias:
        out["b"] = _np(sd[_key(prefix, "bias")])
    return out


def port_lstm_direction(sd: Mapping, prefix: str, suffix: str = "", layer: int = 0) -> dict:
    """One direction of ``nn.LSTM`` layer ``layer`` → ``{w_x, w_h, b}``."""
    b = (_np(sd[_key(prefix, f"bias_ih_l{layer}{suffix}")])
         + _np(sd[_key(prefix, f"bias_hh_l{layer}{suffix}")]))
    return {
        "w_x": _np(sd[_key(prefix, f"weight_ih_l{layer}{suffix}")]).T,
        "w_h": _np(sd[_key(prefix, f"weight_hh_l{layer}{suffix}")]).T,
        "b": b,
    }


def port_bilstm(sd: Mapping, prefix: str) -> dict:
    """Bidirectional ``nn.LSTM`` → ``{"fwd", "bwd"}``, or ``{"layers": [...]}``
    for a stack (the layer count read off the ``weight_ih_l{k}`` keys)."""
    num_layers = 0
    while _key(prefix, f"weight_ih_l{num_layers}") in sd:
        num_layers += 1
    if num_layers == 0:
        raise KeyError(f"no nn.LSTM weights under prefix {prefix!r}")

    def one(layer: int) -> dict:
        return {"fwd": port_lstm_direction(sd, prefix, layer=layer),
                "bwd": port_lstm_direction(sd, prefix, "_reverse", layer=layer)}

    return one(0) if num_layers == 1 else {"layers": [one(k) for k in range(num_layers)]}


def port_highway(sd: Mapping, prefix: str, num_layers: int = 2) -> dict:
    """``HighwayEncoder`` (gates/transforms ModuleLists) → the port's layout."""
    layers = []
    for i in range(num_layers):
        g = port_linear(sd, _key(prefix, f"gates.{i}"))
        t = port_linear(sd, _key(prefix, f"transforms.{i}"))
        layers.append({"gate_w": g["w"], "gate_b": g["b"],
                       "transform_w": t["w"], "transform_b": t["b"]})
    return {"layers": layers}


def port_bidaf_attention(sd: Mapping, prefix: str) -> dict:
    """``BiDAFAttention`` weights ([d,1]/[1,1,d] shapes) → flat vectors."""
    return {
        "w_c": _np(sd[_key(prefix, "c_weight")]).reshape(-1),
        "w_q": _np(sd[_key(prefix, "q_weight")]).reshape(-1),
        "w_cq": _np(sd[_key(prefix, "cq_weight")]).reshape(-1),
        "bias": _np(sd[_key(prefix, "bias")]).reshape(()),
    }


def port_embedding(sd: Mapping, prefix: str) -> dict:
    """``Embedding`` (frozen GloVe + proj + 2-layer highway) → the port's layout."""
    return {
        "table": _np(sd[_key(prefix, "embed.weight")]),
        "proj_w": port_linear(sd, _key(prefix, "proj"), bias=False)["w"],
        "highway": port_highway(sd, _key(prefix, "hwy")),
    }


def port_lstm_cell(sd: Mapping, prefix: str) -> dict:
    """``nn.LSTMCell`` → ``{w_x, w_h, b}`` (same i,f,g,o order)."""
    return {
        "w_x": _np(sd[_key(prefix, "weight_ih")]).T,
        "w_h": _np(sd[_key(prefix, "weight_hh")]).T,
        "b": _np(sd[_key(prefix, "bias_ih")]) + _np(sd[_key(prefix, "bias_hh")]),
    }


def port_decoder(sd: Mapping, prefix: str) -> dict:
    """``SentencePointerDecoder`` → the decoder's parameters."""
    return {
        "lstm": port_lstm_cell(sd, _key(prefix, "cell")),
        **{k: _np(sd[_key(prefix, k)]) for k in ("w_m", "w_d", "v", "start")},
    }


def port_mmbidaf(sd: Mapping, use_images: bool = True, use_audio: bool = True) -> dict:
    """The reference ``MMBiDAF``'s state_dict (numpy arrays or tensors) →
    the port's parameter tree, as numpy arrays."""
    params = {
        "embedding": port_embedding(sd, "emb"),
        "word_lstm": port_bilstm(sd, "word_enc.rnn"),
        "sent_lstm": port_bilstm(sd, "sent_enc.rnn"),
        "decoder": port_decoder(sd, "decoder"),
    }
    if use_images:
        params["img_lstm"] = port_bilstm(sd, "img_enc.rnn")
        params["att_img"] = port_bidaf_attention(sd, "att_img")
    if use_audio:
        params["aud_lstm"] = port_bilstm(sd, "aud_enc.rnn")
        params["att_aud"] = port_bidaf_attention(sd, "att_aud")
    if not use_images and not use_audio:
        params["att_self"] = port_bidaf_attention(sd, "att_self")
    fuse = port_linear(sd, "fuse")
    params["fuse_w"] = fuse["w"]
    params["fuse_b"] = fuse["b"]
    params["model_lstm"] = port_bilstm(sd, "model_enc.rnn")
    return params


def model_from_state_dict(sd: Mapping, cfg: Config, device="cuda") -> MMBiDAF:
    """The port's ``MMBiDAF`` holding the reference state_dict's weights.
    Raises on a missing or unexpected parameter and on a shape mismatch."""
    params = port_mmbidaf(sd, use_images=cfg.model.use_images, use_audio=cfg.model.use_audio)
    model = mmbidaf_init(cfg, params["embedding"]["table"], device)
    load_pytree(model, params)
    return model


# ---------------------------------------------------------------------------
# Reverse direction: the port's model → reference-layout state_dict (numpy).
# ---------------------------------------------------------------------------


def _tree(module: torch.nn.Module) -> dict:
    """A module's parameters as nested dicts, numbered children as lists."""
    root: dict = {}
    for path, v in module.state_dict().items():
        node = root
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _np(v)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _export_linear(out: dict, prefix: str, w, b=None) -> None:
    out[_key(prefix, "weight")] = w.T
    if b is not None:
        out[_key(prefix, "bias")] = b


def _export_lstm_direction(out: dict, prefix: str, p: dict, suffix: str = "",
                           layer: int = 0) -> None:
    out[_key(prefix, f"weight_ih_l{layer}{suffix}")] = p["w_x"].T
    out[_key(prefix, f"weight_hh_l{layer}{suffix}")] = p["w_h"].T
    # torch stores two bias vectors that are summed; split evenly.
    out[_key(prefix, f"bias_ih_l{layer}{suffix}")] = p["b"] * 0.5
    out[_key(prefix, f"bias_hh_l{layer}{suffix}")] = p["b"] * 0.5


def _export_bilstm(out: dict, prefix: str, p: dict) -> None:
    for k, lp in enumerate(p["layers"] if "layers" in p else [p]):
        _export_lstm_direction(out, prefix, lp["fwd"], layer=k)
        _export_lstm_direction(out, prefix, lp["bwd"], "_reverse", layer=k)


def _export_bidaf(out: dict, prefix: str, p: dict) -> None:
    out[_key(prefix, "c_weight")] = p["w_c"].reshape(-1, 1)
    out[_key(prefix, "q_weight")] = p["w_q"].reshape(-1, 1)
    out[_key(prefix, "cq_weight")] = p["w_cq"].reshape(1, 1, -1)
    out[_key(prefix, "bias")] = p["bias"].reshape(1)


def export_mmbidaf(model: MMBiDAF) -> dict:
    """The port's ``MMBiDAF`` → reference-layout ``dict[str, np.ndarray]``."""
    params = _tree(model)
    out: dict = {}
    emb = params["embedding"]
    out["emb.embed.weight"] = emb["table"]
    _export_linear(out, "emb.proj", emb["proj_w"])
    for i, layer in enumerate(emb["highway"]["layers"]):
        _export_linear(out, f"emb.hwy.gates.{i}", layer["gate_w"], layer["gate_b"])
        _export_linear(out, f"emb.hwy.transforms.{i}", layer["transform_w"], layer["transform_b"])
    _export_bilstm(out, "word_enc.rnn", params["word_lstm"])
    _export_bilstm(out, "sent_enc.rnn", params["sent_lstm"])
    if "img_lstm" in params:
        _export_bilstm(out, "img_enc.rnn", params["img_lstm"])
        _export_bidaf(out, "att_img", params["att_img"])
    if "aud_lstm" in params:
        _export_bilstm(out, "aud_enc.rnn", params["aud_lstm"])
        _export_bidaf(out, "att_aud", params["att_aud"])
    if "att_self" in params:
        _export_bidaf(out, "att_self", params["att_self"])
    _export_linear(out, "fuse", params["fuse_w"], params["fuse_b"])
    _export_bilstm(out, "model_enc.rnn", params["model_lstm"])
    dec = params["decoder"]
    out["decoder.cell.weight_ih"] = dec["lstm"]["w_x"].T
    out["decoder.cell.weight_hh"] = dec["lstm"]["w_h"].T
    out["decoder.cell.bias_ih"] = dec["lstm"]["b"] * 0.5
    out["decoder.cell.bias_hh"] = dec["lstm"]["b"] * 0.5
    for k in ("w_m", "w_d", "v", "start"):
        out[f"decoder.{k}"] = dec[k]
    return out
