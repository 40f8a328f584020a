"""Convert a reference PyTorch checkpoint into a port run directory — the
port's counterpart of the repository's ``tools/convert_torch_checkpoint.py``.

The migration path for reference users (SURVEY §4.5): take a
``torch.save``'d checkpoint (a bare ``state_dict`` or the starter-style
``{"model_state": ...}`` wrapper, e.g. ``best.pth.tar``), map every tensor
through ``interop/torch_port.py`` (LSTM gate order i,f,g,o, summed biases,
transposed Linears, ``_reverse`` directions) and write a run directory:
``config.json`` and ``ckpts/`` in the port's own checkpoint format at step 0,
the EMA shadow equal to the params (the reference stores only model
weights). ``--vocab`` (and ``--emb``) go beside them as ``vocab.json`` /
``emb.npz``; without ``--emb`` the table is the checkpoint's own. With a
vocabulary the directory serves through ``Summarizer.from_run``; without
one, ``python -m mmbidaf_tpu_torch.infer --load_dir OUT/ckpts`` rebuilds it
from a corpus. A host-only tool (the CPU):

    python -m mmbidaf_tpu_torch.tools.convert_torch_checkpoint \\
        --torch_ckpt best.pth.tar --config_json cfg.json --out runs/imported \\
        [--vocab vocab.json --emb emb.npz]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch


def read_state_dict(path: str) -> dict:
    """A checkpoint file's model weights: the ``model_state`` (or
    ``state_dict``) entry of a wrapper dict, or the file's own dict. Loaded
    with ``weights_only=True``: tensors and plain containers, no code."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state", blob.get("state_dict", blob))
    return {k: v for k, v in sd.items() if hasattr(v, "shape")}


def convert(torch_ckpt: str, config_json: str, out: str, vocab: str | None = None,
            emb: str | None = None) -> int:
    """Write the run directory ``out``; returns the number of parameters."""
    from mmbidaf_tpu_torch.config import config_from_json
    from mmbidaf_tpu_torch.interop.torch_port import model_from_state_dict
    from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager, save_config
    from mmbidaf_tpu_torch.train.loop import init_train_state

    cfg = config_from_json(config_json)
    model = model_from_state_dict(read_state_dict(torch_ckpt), cfg, "cpu")
    # step 0, a fresh optimizer state, EMA = params
    state = init_train_state(model, cfg, seed=cfg.train.seed + 1)
    save_config(out, cfg)
    CheckpointManager(os.path.join(out, "ckpts"), cfg.train.max_checkpoints, "loss",
                      maximize=False).save(state, {"loss": 0.0})
    if vocab:
        shutil.copyfile(vocab, os.path.join(out, "vocab.json"))
        if emb:
            shutil.copyfile(emb, os.path.join(out, "emb.npz"))
        else:
            np.savez_compressed(os.path.join(out, "emb.npz"),
                                table=model.embedding.table.detach().numpy())
    return sum(p.numel() for p in model.parameters())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch_ckpt", required=True, help=".pt / .pth.tar file")
    ap.add_argument("--config_json", required=True,
                    help="model config matching the checkpoint's architecture")
    ap.add_argument("--out", required=True, help="run directory to create")
    ap.add_argument("--vocab", default=None, help="vocab json (for serving)")
    ap.add_argument("--emb", default=None, help="embedding .npz (for serving; needs --vocab)")
    a = ap.parse_args(argv)
    if a.emb and not a.vocab:
        ap.error("--emb needs --vocab")
    n = convert(a.torch_ckpt, a.config_json, a.out, a.vocab, a.emb)
    print(f"converted {a.torch_ckpt} -> {a.out} ({n / 1e6:.2f}M params, step 0)"
          + ("" if a.vocab else "; no --vocab: Summarizer.from_run needs vocab.json"))


if __name__ == "__main__":
    main()
