"""Where a training step's time goes: the forward, the forward with its
backward, the decoder's gradient alone, and the whole step — the port of
``experiments/train_breakdown.py``.

At the bench widths (``utils/bench_config.py``) in f32 with adadelta, one
synthetic feature batch of ``--batch`` (32) and dropout ``--drop`` (0.2):

- ``forward_loss``: the training forward (dropout drawn from a
  ``torch.Generator``) and the NLL, without gradients;
- ``value_and_grad``: the same loss and its gradients with respect to every
  trainable parameter (no optimizer);
- ``decoder_grad``: the pointer decoder alone, teacher-forced on random
  fused reps ``M``, its gradient with respect to ``model.decoder``'s
  parameters only (JAX's ``params["decoder"]``);
- ``full_train_step``: ``train/loop.py::make_train_step`` (gradients, clip,
  adadelta, EMA), last, as it updates the parameters in place.

``--pallas`` (the JAX flag's name) runs the BiLSTMs and the BiDAF blocks
through the hand kernels K5-K8; without it, the plain versions. Each line
gives the median milliseconds of synchronised calls and the loss (and the
gradient norm) of the first call.

    python -m mmbidaf_tpu_torch.experiments.train_breakdown [--pallas]
    python -m mmbidaf_tpu_torch.experiments.train_breakdown --quick --device cpu --batch 4

One JSON line per part; ``main`` returns them.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.experiments.conv_profile import emit, time_ms

PARTS = ("forward_loss", "value_and_grad", "decoder_grad", "full_train_step")


def breakdown_config(quick: bool, pallas: bool, drop: float):
    """The bench config in f32, adadelta, the trainable kernels under ``pallas``."""
    from mmbidaf_tpu_torch.utils.bench_config import build_bench_config

    cfg = build_bench_config(quick)
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                  use_pallas_attention=pallas, use_pallas_lstm=pallas,
                                  drop_prob=drop),
        train=dataclasses.replace(cfg.train, optimizer="adadelta"))


def forward_loss(params, batch: dict, cfg, generator: torch.Generator) -> torch.Tensor:
    """The training forward's NLL (no gradients)."""
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_apply
    from mmbidaf_tpu_torch.train.loop import nll_loss

    with torch.no_grad():
        log_p = mmbidaf_apply(params, batch, cfg, generator=generator)
        return nll_loss(log_p, batch["targets"], batch["target_mask"])


def value_and_grad(params, batch: dict, cfg, generator: torch.Generator):
    """The training loss and its gradients ``{name: grad}`` over every
    trainable parameter."""
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_apply
    from mmbidaf_tpu_torch.train.loop import nll_loss, trainable_parameters

    named = trainable_parameters(params)
    log_p = mmbidaf_apply(params, batch, cfg, generator=generator)
    loss = nll_loss(log_p, batch["targets"], batch["target_mask"])
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.detach(), {n: (g if g is not None else torch.zeros_like(p))
                           for (n, p), g in zip(named, grads)}


def decoder_grad(decoder, M: torch.Tensor, batch: dict, cfg):
    """The teacher-forced decoder's NLL on ``M [B, T_s, 2h]`` and its
    gradients ``{name: grad}`` over ``decoder``'s parameters alone."""
    from mmbidaf_tpu_torch.models.decoder import decoder_apply
    from mmbidaf_tpu_torch.train.loop import nll_loss

    named = [(n, p.requires_grad_(True)) for n, p in decoder.named_parameters()]
    log_p, _ = decoder_apply(decoder, M, batch["sent_mask"], targets=batch["targets"],
                             num_steps=cfg.model.max_decode_steps, teacher_forcing=True,
                             mask_selected=cfg.model.mask_selected)
    loss = nll_loss(log_p, batch["targets"], batch["target_mask"])
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.detach(), {n: (g if g is not None else torch.zeros_like(p))
                           for (n, p), g in zip(named, grads)}


def grad_norm(grads: dict) -> float:
    return float(torch.sqrt(sum(torch.sum(g.double() * g.double()) for g in grads.values())))


def main(argv=None) -> list[dict]:
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.loop import init_train_state, make_train_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pallas", action="store_true", help="the hand kernels K5-K8")
    ap.add_argument("--drop", type=float, default=0.2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--quick", action="store_true", help="small shapes (the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    cfg = breakdown_config(a.quick, a.pallas, a.drop)
    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    model = mmbidaf_init(cfg, wv, dev, seed=0)
    state = init_train_state(model, cfg, seed=1)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(rng, cfg, batch_size=a.batch).items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.Generator(device=dev).manual_seed(0)
    M = torch.randn(a.batch, cfg.data.max_sentences, 2 * cfg.model.hidden_size, generator=g,
                    device=dev)
    out: list[dict] = []
    emit({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          "pallas": a.pallas, "drop": a.drop, "batch": a.batch}, out)

    loss = forward_loss(state.params, batch, cfg, gen)
    emit({"op": "forward_loss", "ms": time_ms(lambda: forward_loss(state.params, batch, cfg, gen),
                                              a.iters), "loss": float(loss)}, out)
    loss, grads = value_and_grad(state.params, batch, cfg, gen)
    emit({"op": "value_and_grad",
          "ms": time_ms(lambda: value_and_grad(state.params, batch, cfg, gen), a.iters),
          "loss": float(loss), "grad_norm": grad_norm(grads)}, out)
    loss, grads = decoder_grad(state.params.decoder, M, batch, cfg)
    emit({"op": "decoder_grad",
          "ms": time_ms(lambda: decoder_grad(state.params.decoder, M, batch, cfg), a.iters),
          "loss": float(loss), "grad_norm": grad_norm(grads)}, out)
    # the full step last: it updates the parameters in place
    train_step = make_train_step(cfg)
    _, metrics = train_step(state, batch)
    first = {k: float(v) for k, v in metrics.items()}
    emit({"op": "full_train_step", "ms": time_ms(lambda: train_step(state, batch)[1]["loss"],
                                                 a.iters), **first}, out)
    return out


if __name__ == "__main__":
    main()
