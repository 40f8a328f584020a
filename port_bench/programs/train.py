"""Program kind ``train``: ``mmbidaf_tpu_torch.train.loop.make_train_step(cfg)``
on ``(state, batch)``, steps dispatched back to back. Set-up builds the one
state the window trains and drives it through its first ``check_steps``
steps, keeping what the output check reads: each step's loss, the
optimizer's state after the first, the parameters and their EMA after the
last.

Batches are feature batches as the train step takes them, the distribution
of ``mmbidaf_tpu_torch/data/synthetic.py::synthetic_batch``: sentence
counts in [max(K, 2), T_s], words in [1, W], keyframes and audio frames
from 1 to the cap (row 0 at every cap); unit-normal image and audio
features; K distinct gold sentences a row.

The output check: those steps against the reference trained from the same
weights, batches and dropout draws (``check.train_numbers``).
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from pbench import check, port
from pbench.traffic import sub_seed
from reference import mmbidaf_ref as ref

SPANS = ("train_step",)
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def layouts(cfg: dict) -> dict:
    return {"model": ref.model_layout(cfg)}


def _lengths(gen, n: int, lo: int, hi: int, device) -> torch.Tensor:
    ls = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    ls[0] = hi
    return ls


def _prefix_mask(lengths: torch.Tensor, cap: int) -> torch.Tensor:
    return (torch.arange(cap, device=lengths.device) < lengths[..., None]).float()


def make_batch(cfg: dict, mix: dict, gen: torch.Generator, device) -> dict:
    d, m = cfg["data"], cfg["model"]
    B, K = mix["batch"], m["max_decode_steps"]
    T_s, W, T_i, T_a = d["max_sentences"], d["max_words"], d["max_keyframes"], d["max_audio_frames"]
    sent_mask = _prefix_mask(_lengths(gen, B, max(K, 2), T_s, device), T_s)
    n_words = torch.randint(1, W + 1, (B, T_s), generator=gen, device=device)
    word_mask = _prefix_mask(n_words, W) * sent_mask[:, :, None]
    text_ids = torch.randint(2, d["vocab_size"], (B, T_s, W), generator=gen, device=device,
                             dtype=torch.int32) * word_mask.int()
    img_mask = _prefix_mask(_lengths(gen, B, 1, T_i, device), T_i)
    images = torch.randn(B, T_i, m["img_feat_dim"], generator=gen, device=device) * img_mask[:, :, None]
    aud_mask = _prefix_mask(_lengths(gen, B, 1, T_a, device), T_a)
    audio = torch.randn(B, T_a, m["audio_feat_dim"], generator=gen, device=device) * aud_mask[:, :, None]
    keys = torch.rand(B, T_s, generator=gen, device=device) + (1 - sent_mask) * 2
    targets = keys.argsort(dim=1)[:, :K].int()
    return {"text_ids": text_ids, "word_mask": word_mask, "sent_mask": sent_mask,
            "images": images, "img_mask": img_mask, "audio": audio, "aud_mask": aud_mask,
            "targets": targets, "target_mask": torch.ones(B, K, device=device)}


class Program:
    def __init__(self, cfg: dict, mix: dict, weights: dict, device, dropout_seed: int):
        from mmbidaf_tpu_torch.train.loop import init_train_state, make_train_step

        self.device, self.mix = device, mix
        self.pcfg = port.port_config(cfg)
        model = port.build_model(self.pcfg, weights["model"], device)
        self.state = init_train_state(model, self.pcfg, seed=dropout_seed)
        self.entry = make_train_step(self.pcfg)
        self.first = {}

    def call(self, batch):
        self.state, metrics = self.entry(self.state, batch)
        return metrics

    def warm(self, pool: list) -> None:
        """The first ``check_steps`` steps, on distinct batches, through the
        window's own call; what the check reads is copied as they pass."""
        losses = []
        for k in range(self.mix["check_steps"]):
            losses.append(self.call(pool[k])["loss"])
            if k == 0:
                self.first["opt_state"] = {key: [t.detach().clone() for t in v]
                                           for key, v in self.state.opt_state.items()
                                           if isinstance(v, list)}
        self.first["losses"] = losses
        self.first["params"] = {n: p.detach().clone() for n, p in self.state.params.named_parameters()
                                if p.requires_grad}
        ema = dict(self.state.ema_params.named_parameters())
        self.first["ema"] = {n: ema[n].detach().clone() for n in self.first["params"]}
        port.sync(self.device)

    def window(self, pool: list, seconds: float, traced: bool) -> port.Window:
        k0 = self.mix["check_steps"]
        n = 0
        port.sync(self.device)
        start = time.perf_counter()
        while True:
            batch = pool[(k0 + n) % len(pool)]
            if traced:
                with record_function("train_step"):
                    self.call(batch)
            else:
                self.call(batch)
            n += 1
            if time.perf_counter() - start >= seconds:
                break
        port.sync(self.device)
        return port.Window(n, start, time.perf_counter() - start, [], [])

    def record(self) -> dict:
        """What the check reads of the first steps: losses, the first
        gradient (from the optimizer's state), parameters and EMA."""
        names = [n for n, p in self.state.params.named_parameters() if p.requires_grad]
        shapes = {n: self.first["params"][n].shape for n in names}
        return {"losses": [float(x) for x in self.first["losses"]],
                "grads": check.adadelta_grads(self.first["opt_state"], names, shapes),
                "params": self.first["params"], "ema": self.first["ema"]}

    def free(self) -> None:
        del self.state, self.entry


def build(cfg: dict, mix: dict, weights: dict, seed: int, device) -> Program:
    return Program(cfg, mix, weights, device, sub_seed(seed, "dropout"))


def reference(cfg: dict, w: dict, pool: list, steps: int, dropout_seed: int,
              prec: ref.Prec = ref.F64) -> dict:
    """The reference trained through the same first steps, recorded alike."""
    trainer = ref.Trainer(w["model"], cfg, dropout_seed, prec)
    losses, grads = [], None
    for k in range(steps):
        loss, g = trainer.step(pool[k])
        losses.append(loss)
        grads = g if grads is None else grads
    return {"losses": losses, "grads": grads,
            "params": {n: trainer.w[n].detach() for n in trainer.names}, "ema": trainer.ema}


def numbers(cfg: dict, mix: dict, w: dict, pool: list, window: port.Window, record: dict, seed: int,
            leaves: dict | None = None) -> dict:
    ref_rec = reference(cfg, w, pool, mix["check_steps"], sub_seed(seed, "dropout"))
    return check.train_numbers(record, ref_rec, w["model"], leaves)


def half_batch(step):
    """A train step that leaves out half of each batch: the mean over the rest."""
    def half(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return half


def unchanged(step):
    """A train step that returns its state unchanged (its loss as computed)."""
    def same(state, batch):
        params = {n: p.detach().clone() for n, p in state.params.named_parameters()}
        ema = {n: p.detach().clone() for n, p in state.ema_params.named_parameters()}
        opt = {k: [t.clone() for t in v] for k, v in state.opt_state.items() if isinstance(v, list)}
        state, metrics = step(state, batch)
        with torch.no_grad():
            for n, p in state.params.named_parameters():
                p.copy_(params[n])
            for n, p in state.ema_params.named_parameters():
                p.copy_(ema[n])
            for k, v in opt.items():
                for t, old in zip(state.opt_state[k], v):
                    t.copy_(old)
        return state, metrics
    return same


def readings(cfg: dict, mix: dict, seed: int, kind: str, device) -> dict:
    """``calibrate.py``'s readings of the first ``check_steps`` steps: the
    program (``program``), with half of each batch left out (``fault``) or
    its state left unchanged (``unchanged``), or the reference with TF32
    products in the program's place (``control``). The three worst leaves
    of each number go to standard error."""
    import sys

    from pbench import core

    w, pool = core.make_inputs(cfg, mix, seed, device)
    steps, drop_seed = mix["check_steps"], sub_seed(seed, "dropout")
    if kind == "control":
        with ref.ieee_f32():
            record = reference(cfg, w, pool, steps, drop_seed, prec=ref.Prec("tf32"))
    else:
        prog = build(cfg, mix, w, seed, device)
        if kind == "fault":
            prog.entry = half_batch(prog.entry)
        elif kind == "unchanged":
            prog.entry = unchanged(prog.entry)
        elif kind != "program":
            raise ValueError(f"training has no reading {kind!r}")
        prog.warm(pool)
        record = prog.record()
        prog.free()
        del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    leaves = {}
    with ref.ieee_f32():
        out = numbers(cfg, mix, w, pool, None, record, seed, leaves)
    for k, by_leaf in leaves.items():
        top = sorted(by_leaf.items(), key=lambda kv: -kv[1])[:3]
        print(f"{kind} {seed} {k} worst leaves: {top}", file=sys.stderr)
    return out
