"""Training step, loss, optimizer and EMA — the port of ``mmbidaf_tpu.train.loop``.

``make_train_step(cfg, frontend=None, vgg_spec=None)`` returns
``train_step(state, batch) → (state, metrics)``: on a raw batch the frozen
frontend first (VGG, and the MFCC through K3), then teacher-forced NLL,
gradients by autograd (through the K5–K8 kernels when the kernel flags are
on), optax-style clip + adadelta/adam, and the bias-corrected EMA. PyTorch runs eagerly, so the step is a plain
function; it updates the parameters, the optimizer state and the EMA shadow
in place (the JAX step donates its buffers to the same end) and returns the
same ``state`` object. ``metrics`` holds 0-d device tensors: reading them
synchronises, so a loop reads them only when it logs.

Optimizer semantics follow optax exactly, not ``torch.optim``:

- the GloVe table is frozen: no optimizer state, a zero update, and its
  EMA shadow is the table itself (the same tensor);
- ``clip_by_global_norm``: ``g·max_norm/norm`` only when ``norm ≥ max_norm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` always);
- adadelta as ``optax.scale_by_adadelta`` (ρ 0.9, ε 1e-6, ``E[Δx²]`` in the
  numerator), adam as ``optax.scale_by_adam`` (β 0.9/0.999, ε 1e-8, bias
  correction); the learning rate is ``make_lr_schedule(cfg)`` at the number
  of updates taken before this one;
- ``flat_updates``: weight decay, clip and optimizer on one raveled vector of
  the trainable leaves; otherwise per leaf, with the clip norm over every
  leaf — the frozen table's zero gradient, plus ``l2_wd·table`` when
  ``l2_wd > 0``, as ``optax.add_decayed_weights`` before the clip adds it.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Mapping

import numpy as np
import torch

from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.models.mmbidaf import MMBiDAF, mmbidaf_apply, mmbidaf_decode
from mmbidaf_tpu_torch.parallel.mesh import _data_axes, all_reduce, grad_axes

_ADADELTA_RHO, _ADADELTA_EPS = 0.9, 1e-6
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def nll_sum(log_probs: torch.Tensor, targets: torch.Tensor,
            target_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed NLL and the valid-step count (the unnormalised pieces that
    gradient accumulation sums before it divides once)."""
    gold = log_probs.gather(-1, targets.long()[..., None])[..., 0]  # [B, K]
    target_mask = target_mask.to(log_probs.dtype)
    return -(gold * target_mask).sum(), target_mask.sum()


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             target_mask: torch.Tensor) -> torch.Tensor:
    """Mean per-step NLL against the gold sentence indices."""
    total, count = nll_sum(log_probs, targets, target_mask)
    return total / torch.clamp(count, min=1.0)


def is_frozen(name: str) -> bool:
    """The GloVe table (``requires_grad=False`` in the reference)."""
    return name.split(".")[-1] == "table"


def trainable_parameters(params: MMBiDAF) -> list[tuple[str, torch.nn.Parameter]]:
    return [(n, p) for n, p in params.named_parameters() if not is_frozen(n)]


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Warmup + {constant, cosine, exponential} decay, as ``optax``'s
    schedules: ``lr(count)`` for the update that follows ``count`` updates."""
    t = cfg.train
    lr, floor = t.lr, t.lr * t.lr_min_ratio
    if t.lr_schedule == "constant":
        def main(count):
            return lr
    elif t.lr_schedule == "cosine":
        def main(count):
            frac = min(count, t.decay_steps) / t.decay_steps
            return lr * ((1.0 - t.lr_min_ratio) * 0.5 * (1.0 + math.cos(math.pi * frac))
                         + t.lr_min_ratio)
    elif t.lr_schedule == "exponential":
        def main(count):
            if count <= 0 or t.decay_steps <= 0 or t.lr_min_ratio == 0:
                return lr
            value = lr * t.lr_min_ratio ** (count / t.decay_steps)
            return max(value, floor) if t.lr_min_ratio < 1.0 else min(value, floor)
    else:
        raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")
    if t.warmup_steps <= 0:
        return main

    def schedule(count):
        if count < t.warmup_steps:
            return lr * min(max(count, 0), t.warmup_steps) / t.warmup_steps
        return main(count - t.warmup_steps)

    return schedule


class Optimizer:
    """The optax chain of ``mmbidaf_tpu.train.loop.make_optimizer`` on the
    trainable leaves. ``init`` makes the state; ``update`` applies one update
    to the parameters and the state in place."""

    def __init__(self, cfg: Config):
        t = cfg.train
        if t.optimizer not in ("adadelta", "adam"):
            raise ValueError(f"unknown optimizer {t.optimizer!r}")
        self.kind = t.optimizer
        self.flat = t.flat_updates
        self.max_norm = t.max_grad_norm
        self.wd = t.l2_wd
        self.schedule = make_lr_schedule(cfg)

    def init(self, params: MMBiDAF) -> dict:
        leaves = [p.detach() for _, p in trainable_parameters(params)]
        if self.flat:
            leaves = [torch.cat([p.reshape(-1) for p in leaves])]
        names = ("e_g", "e_x") if self.kind == "adadelta" else ("mu", "nu")
        return {"count": 0, **{n: [torch.zeros_like(p) for p in leaves] for n in names}}

    def _moments(self, g: torch.Tensor, state: dict, i: int, count: int) -> torch.Tensor:
        """The optimizer's scaled direction for leaf ``i`` (before the -lr)."""
        if self.kind == "adadelta":
            e_g = state["e_g"][i].mul_(_ADADELTA_RHO).add_((1.0 - _ADADELTA_RHO) * (g * g))
            u = torch.sqrt(state["e_x"][i] + _ADADELTA_EPS) / torch.sqrt(e_g + _ADADELTA_EPS) * g
            state["e_x"][i].mul_(_ADADELTA_RHO).add_((1.0 - _ADADELTA_RHO) * (u * u))
            return u
        mu = state["mu"][i].mul_(_ADAM_B1).add_((1.0 - _ADAM_B1) * g)
        nu = state["nu"][i].mul_(_ADAM_B2).add_((1.0 - _ADAM_B2) * (g * g))
        n = count + 1  # optax takes the bias corrections in f32
        mu_hat = mu / float(np.float32(1.0) - np.float32(_ADAM_B1) ** n)
        nu_hat = nu / float(np.float32(1.0) - np.float32(_ADAM_B2) ** n)
        return mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)

    @torch.no_grad()
    def update(self, params: MMBiDAF, grads: list[torch.Tensor], state: dict) -> None:
        trainable = [p for _, p in trainable_parameters(params)]
        if self.flat:
            g = torch.cat([x.reshape(-1) for x in grads])
            if self.wd > 0:
                g = g + self.wd * torch.cat([p.reshape(-1) for p in trainable])
            gs = [g]
            norm = torch.linalg.vector_norm(g)
        else:
            gs = [g + self.wd * p if self.wd > 0 else g for g, p in zip(grads, trainable)]
            sq = sum(torch.sum(g * g) for g in gs)
            if self.wd > 0:  # the frozen table's decayed weight enters the norm
                sq = sq + sum(torch.sum((self.wd * p) ** 2)
                              for n, p in params.named_parameters() if is_frozen(n))
            norm = torch.sqrt(sq)
        clipped = norm >= self.max_norm
        gs = [torch.where(clipped, g / norm * self.max_norm, g) for g in gs]
        lr = self.schedule(state["count"])
        updates = [-lr * self._moments(g, state, i, state["count"]) for i, g in enumerate(gs)]
        state["count"] += 1
        if self.flat:
            updates = torch.split(updates[0], [p.numel() for p in trainable])
        for p, u in zip(trainable, updates):
            p.add_(u.view_as(p))


def make_optimizer(cfg: Config) -> Optimizer:
    return Optimizer(cfg)


@dataclasses.dataclass
class TrainState:
    """``step`` (updates taken), ``params`` (trainable leaves require grad),
    ``opt_state``, ``ema_params`` (shares the frozen table with ``params``)
    and the dropout ``generator``, on the training device."""

    step: int
    params: MMBiDAF
    opt_state: dict
    ema_params: MMBiDAF
    generator: torch.Generator


def init_train_state(params: MMBiDAF, cfg: Config, seed: int = 0) -> TrainState:
    """Train state around ``params`` (taken, not copied): gradients on for
    every trainable leaf, a fresh optimizer state, the EMA shadow a copy of
    the parameters, and a dropout generator seeded with ``seed`` on the
    parameters' device."""
    for n, p in params.named_parameters():
        p.requires_grad_(not is_frozen(n))
    table = params.embedding.table
    params.embedding.table = None  # the EMA shares the table, not a copy of it
    ema = copy.deepcopy(params)
    params.embedding.table = ema.embedding.table = table
    for p in ema.parameters():
        p.requires_grad_(False)
    gen = torch.Generator(device=table.device).manual_seed(seed)
    return TrainState(step=0, params=params, opt_state=make_optimizer(cfg).init(params),
                      ema_params=ema, generator=gen)


def make_train_step(cfg: Config, frontend=None, vgg_spec=None, mesh=None,
                    audio_g_fn: Callable | None = None) -> Callable:
    """``train_step(state, batch) → (state, {"loss", "grad_norm"})`` for
    config ``cfg`` on feature batches (``synthetic_batch`` layout, tensors
    on the parameters' device). With ``grad_accum_steps > 1`` the batch is
    split into microbatches whose unnormalised NLLs and valid-step counts
    sum to the full batch's, divided once: the full-batch gradient.

    With a ``frontend`` (``data.frontend.Frontend``; ``vgg_spec`` its conv
    spec, VGG-16 by default) a batch may be RAW — it carries ``frames`` or
    ``waveform`` (``data.pipeline.VideoCorpus``'s schema): the frozen
    frontend turns it into features inside the step, under
    ``torch.no_grad()`` (not ``inference_mode``: its outputs enter the
    model's autograd graph as constants), per microbatch under
    accumulation so the VGG activations shrink by ``1/accum``. The frontend
    draws nothing from ``state.generator``. Its VGG weights are held in the
    compute dtype once, here (``cast_vgg_weights``).

    With a ``mesh`` (``parallel.mesh.make_mesh``) the step is data-parallel:
    ``batch`` is this rank's rows of the global batch (``shard_batch``), the
    dropout masks are drawn for the global batch and cut to them, the loss
    is normalised by the global valid-step count, and one all-reduce of the
    flat gradient buffer (the trainable leaves in order) sums the gradients
    over every axis but ``model`` before the clip takes the global norm.
    ``audio_g_fn`` (``parallel.sp_tower``, ``MeshConfig.sp_audio``) runs the
    audio tower sequence-parallel on raw waveform batches; the ranks along
    ``seq`` hold the same rows, each counts ``1/num_seq`` of their loss, and
    the same all-reduce sums their shares of the tower's gradients. At world
    size 1 without a process group every collective is skipped, and the step
    is the step without a mesh."""
    tx = make_optimizer(cfg)
    decay = cfg.train.ema_decay
    accum = cfg.train.grad_accum_steps
    if frontend is not None:
        from mmbidaf_tpu_torch.data.frontend import apply_frontend, cast_vgg_weights
        from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC

        frontend = cast_vgg_weights(frontend, cfg.model.compute_dtype)
        spec = vgg_spec or VGG16_SPEC
    elif audio_g_fn is not None:
        raise ValueError("audio_g_fn (MeshConfig.sp_audio) needs raw waveform batches — pass "
                         "the frontend so the train step featurizes them")
    group = mesh.group(grad_axes(mesh)) if mesh is not None else None
    n_data = 1 if mesh is None else mesh.axis_size(_data_axes(mesh))
    i_data = 0 if mesh is None else mesh.axis_index(_data_axes(mesh))

    def featurize(part: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
        if audio_g_fn is not None and "waveform" not in part:
            raise ValueError("MeshConfig.sp_audio: the batch must carry the raw 'waveform' "
                             "(precomputed-feature batches cannot feed the sequence-parallel "
                             "frontend)")
        if "frames" not in part and "waveform" not in part:
            return part
        if frontend is None:
            raise ValueError("a raw batch (frames / waveform) needs make_train_step(cfg, frontend)")
        with torch.no_grad():
            feat = apply_frontend(frontend, part, cfg, spec, sp_audio=audio_g_fn is not None)
        feat["targets"], feat["target_mask"] = part["targets"], part["target_mask"]
        return feat

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        trainable = [p for _, p in trainable_parameters(state.params)]
        for p in trainable:
            p.grad = None
        b_dim = next(iter(batch.values())).shape[0]
        if b_dim % accum:
            raise ValueError(f"grad_accum_steps {accum} must divide batch size {b_dim}")
        denom = torch.clamp(all_reduce(batch["target_mask"].sum(), group), min=1.0)
        loss = 0.0
        mb = b_dim // accum
        rows = (i_data * mb, (i_data + 1) * mb, n_data * mb) if n_data > 1 else None
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()} if accum > 1 else batch
            part = featurize(part)
            log_p = mmbidaf_apply(state.params, part, cfg, generator=state.generator,
                                  audio_g_fn=audio_g_fn, rows=rows)
            total, _ = nll_sum(log_p, part["targets"], part["target_mask"])
            (total / denom).backward()
            loss = loss + total.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in trainable]
        if group is not None:
            # one all-reduce of the flat gradient buffer, leaves in order
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
            grads = [g.view_as(p) for g, p in
                     zip(torch.split(flat, [p.numel() for p in trainable]), trainable)]
            loss = all_reduce(torch.as_tensor(loss, device=denom.device).clone(), group)
        with torch.no_grad():
            grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        tx.update(state.params, grads, state.opt_state)
        state.step += 1
        # optax's EMA weight, in f32 as there
        d = min(np.float32(decay), np.float32(1.0 + state.step) / np.float32(10.0 + state.step))
        with torch.no_grad():
            pairs = [(e, p) for (n, e), (_, p) in zip(state.ema_params.named_parameters(),
                                                      state.params.named_parameters())
                     if not is_frozen(n)]
            ema, cur = [e for e, _ in pairs], [p for _, p in pairs]
            torch._foreach_mul_(ema, float(d))
            torch._foreach_add_(ema, cur, alpha=float(np.float32(1.0) - d))
        for p in trainable:
            p.grad = None
        return state, {"loss": loss / denom, "grad_norm": grad_norm}

    return train_step


def make_eval_step(cfg: Config, audio_g_fn: Callable | None = None) -> Callable:
    """``eval_step(params, batch) → {"loss", "picks"}``: the teacher-forced
    loss (greedy decode masks picked sentences, so the gold index may be
    masked there) and the greedy picks, without gradients. ``audio_g_fn``:
    the sequence-parallel audio tower (the batch then carries ``waveform``);
    every rank of the mesh evaluates the whole batch."""

    @torch.no_grad()
    def eval_step(params: MMBiDAF, batch: Mapping[str, torch.Tensor]):
        log_p_tf = mmbidaf_apply(params, batch, cfg, audio_g_fn=audio_g_fn)
        loss = nll_loss(log_p_tf, batch["targets"], batch["target_mask"])
        _, picks = mmbidaf_decode(params, batch, cfg, audio_g_fn=audio_g_fn)
        return {"loss": loss, "picks": picks}

    return eval_step
