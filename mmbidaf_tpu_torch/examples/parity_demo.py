"""Executable parity demo: a reference-style PyTorch checkpoint served by
the port — the port of ``examples/parity_demo.py``.

Builds the reference model (the oracle of ``tests/oracles/torch_model.py``,
the MMBiDAF starter's module layout), carries its ``state_dict`` through
``interop/torch_port.py::model_from_state_dict``, and runs the port's greedy
decode on the card with the hand kernels on (K1, K2) against the oracle's
own forward on the CPU: the largest log-prob distance at valid positions,
and the greedy picks, which must be equal.

    python -m mmbidaf_tpu_torch.examples.parity_demo                 # the card
    python -m mmbidaf_tpu_torch.examples.parity_demo --device cpu    # the CPU

The oracle is read from the repository checkout (``--oracle``); the demo
ends with ``PARITY OK``, and ``main`` returns the distance and the picks.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ORACLE = os.path.join(REPO, "tests", "oracles", "torch_model.py")
# f32 on both sides with sums in different orders: the JAX demo's bound
MAX_LOG_P_DISTANCE = 5e-5


def load_oracle(path: str = ORACLE):
    """The reference model's module (a file of the checkout, not a package)."""
    if not os.path.isfile(path):
        raise SystemExit(f"no reference oracle at {path}: run from a checkout of the repository "
                         "or pass --oracle")
    spec = importlib.util.spec_from_file_location("torch_model", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> dict:
    from mmbidaf_tpu_torch.config import tiny_test_config
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu_torch.interop.torch_port import model_from_state_dict
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--oracle", default=ORACLE, help="the reference model's module file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    oracle = load_oracle(a.oracle)

    cfg = tiny_test_config(hidden_size=24)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pallas_lstm=True, use_pallas_attention=True))
    m = cfg.model
    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, cfg.data.vocab_size, m.emb_dim)
    torch.manual_seed(0)
    reference = oracle.MMBiDAF(
        torch.from_numpy(wv), m.hidden_size, img_feat_dim=m.img_feat_dim,
        audio_feat_dim=m.audio_feat_dim, num_decode_steps=m.max_decode_steps,
    ).eval()
    print(f"torch reference: {sum(p.numel() for p in reference.parameters()):,} params")

    model = model_from_state_dict(reference.state_dict(), cfg, dev)  # the checkpoint import
    print(f"ported state_dict -> {sum(1 for _ in model.parameters())} tensors on {dev}")

    batch = synthetic_batch(rng, cfg, batch_size=2)
    with torch.inference_mode():
        log_p, picks = mmbidaf_decode(model, {k: torch.from_numpy(v).to(dev)
                                              for k, v in batch.items()}, cfg)
    with torch.no_grad():
        t_log_p, t_picks = reference(
            text_ids=torch.from_numpy(batch["text_ids"]).long(),
            word_mask=torch.from_numpy(batch["word_mask"]),
            sent_mask=torch.from_numpy(batch["sent_mask"]),
            images=torch.from_numpy(batch["images"]),
            img_mask=torch.from_numpy(batch["img_mask"]),
            audio=torch.from_numpy(batch["audio"]),
            aud_mask=torch.from_numpy(batch["aud_mask"]),
        )
    log_p, picks = log_p.cpu().numpy(), picks.cpu().numpy()
    valid = np.broadcast_to(batch["sent_mask"][:, None, :] > 0, t_log_p.shape)
    max_err = float(np.abs(log_p[valid] - t_log_p.numpy()[valid]).max())
    picks_match = bool((picks == t_picks.numpy()).all())
    print(f"forward max |dlog_p| at valid positions: {max_err:.3e}")
    print(f"greedy picks identical: {picks_match}")
    print(f"  torch picks: {t_picks.numpy().tolist()}")
    print(f"  port picks:  {picks.tolist()}")
    if not (max_err < MAX_LOG_P_DISTANCE and picks_match):
        raise SystemExit(f"parity failed: distance {max_err:.3e}, picks equal {picks_match}")
    print("PARITY OK", flush=True)
    return {"max_abs_log_p": max_err, "picks_equal": picks_match, "picks": picks.tolist()}


if __name__ == "__main__":
    main()
