"""Program kind ``serve``: the closure of
``mmbidaf_tpu_torch.data.frontend.make_end_to_end_decode(cfg, VGG16_SPEC)``
on ``(model, cast_vgg_weights(frontend), raw)``, one client in a closed
loop: each batch ends with its picks copied to the host. The traced window
makes the closure's two calls itself (``apply_frontend``, then
``mmbidaf_decode``), each inside a span of its own.

Batches are raw videos as the program takes them: text ids at the caps,
``frame_hw`` uint8 keyframes, a noise waveform of ``waveform_std`` covering
``max_audio_frames`` frames, full masks (the shapes of
``mmbidaf_tpu_torch/utils/bench_config.py::make_raw_batch_on_device``).

The output check: one served batch of each batch of the pool, drawn from
the seed, against the reference fed the served picks
(``check.serve_numbers``).
"""

from __future__ import annotations

import random
import time

import torch
from torch.profiler import record_function

from pbench import check, port
from pbench.weights import load_into
from pbench.traffic import sub_seed
from reference import mmbidaf_ref as ref

SPANS = ("frontend", "model")
NUMBERS = ("pick_gap", "logp_err")


def layouts(cfg: dict) -> dict:
    return {"model": ref.model_layout(cfg), "vgg": ref.vgg_layout(cfg)}


def make_batch(cfg: dict, mix: dict, gen: torch.Generator, device) -> dict:
    d = cfg["data"]
    B = mix["batch"]
    T_s, W, T_i, T_a = d["max_sentences"], d["max_words"], d["max_keyframes"], d["max_audio_frames"]
    n_samples = T_a * d["hop_length"] + d["win_length"]
    ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
    return {
        "text_ids": torch.randint(2, d["vocab_size"], (B, T_s, W), generator=gen, device=device,
                                  dtype=torch.int32),
        "word_mask": ones(B, T_s, W), "sent_mask": ones(B, T_s),
        "img_mask": ones(B, T_i), "aud_mask": ones(B, T_a),
        "frames": torch.randint(0, 256, (B, T_i, *mix["frame_hw"], 3), generator=gen, device=device,
                                dtype=torch.uint8),
        "waveform": torch.randn(B, n_samples, generator=gen, device=device) * mix["waveform_std"],
    }


class Program:
    def __init__(self, cfg: dict, mix: dict, weights: dict, device):
        from mmbidaf_tpu_torch.data.frontend import (cast_vgg_weights, frontend_init,
                                                     make_end_to_end_decode)
        from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC

        self.device, self.mix = device, mix
        self.pcfg = port.port_config(cfg)
        self.model = port.build_model(self.pcfg, weights["model"], device)
        fe = frontend_init(self.pcfg, VGG16_SPEC, device, seed=0)
        load_into(fe.vgg, weights["vgg"])
        self.fe = cast_vgg_weights(fe, self.pcfg.model.compute_dtype)
        del fe
        self.spec = VGG16_SPEC
        self.entry = make_end_to_end_decode(self.pcfg, VGG16_SPEC)

    def call(self, raw):
        return self.entry(self.model, self.fe, raw)

    def traced_call(self, raw):
        from mmbidaf_tpu_torch.data.frontend import apply_frontend
        from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode

        with torch.inference_mode():
            with record_function("frontend"):
                batch = apply_frontend(self.fe, raw, self.pcfg, self.spec)
            with record_function("model"):
                return mmbidaf_decode(self.model, batch, self.pcfg)

    def warm(self, pool: list) -> None:
        """The pool's one shape, twice: kernels load, cuDNN and cuBLAS choose."""
        for raw in pool[:2]:
            self.call(raw)[1].cpu()
        port.sync(self.device)

    def window(self, pool: list, seconds: float, traced: bool) -> port.Window:
        fn = self.traced_call if traced else self.call
        lat, outs = [], []
        port.sync(self.device)
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            log_p, picks = fn(pool[len(outs) % len(pool)])
            picks = picks.cpu()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            outs.append((log_p, picks))
            if t1 - start >= seconds:
                break
        port.sync(self.device)
        return port.Window(len(outs), start, time.perf_counter() - start, lat, outs)

    def record(self) -> None:
        """Nothing beyond the window: its outputs are what the check reads."""
        return None

    def free(self) -> None:
        del self.model, self.fe, self.entry


def build(cfg: dict, mix: dict, weights: dict, seed: int, device) -> Program:
    return Program(cfg, mix, weights, device)


def check_sample(window: port.Window, pool_size: int, seed: int) -> list[int]:
    """One served batch of each batch of the pool, drawn from the seed."""
    rng = random.Random(sub_seed(seed, "check"))
    by_pool = {}
    for i in range(window.units):
        by_pool.setdefault(i % pool_size, []).append(i)
    return [rng.choice(v) for _, v in sorted(by_pool.items())]


def numbers(cfg: dict, mix: dict, w: dict, pool: list, window: port.Window, record, seed: int,
            prec: ref.Prec = ref.F32) -> dict:
    out = {}
    for i in check_sample(window, len(pool), seed):
        raw = pool[i % len(pool)]
        log_p, picks = window.outputs[i]
        ref_logp, _ = ref.serve(w["model"], w["vgg"], raw, cfg, feed=picks.to(log_p.device), prec=prec)
        out = check.worst(out, check.serve_numbers(
            log_p, picks, ref_logp, raw["sent_mask"], cfg["model"]["mask_selected"]))
    return out


def readings(cfg: dict, mix: dict, seed: int, kind: str, device) -> dict:
    """``calibrate.py``'s readings: every batch of the pool served once and
    judged as a run judges its sample (``program``); a served pick altered
    where it is produced (``fault``); the reference with fp8 products on
    the program's path in the program's place (``control``)."""
    from pbench import core

    w, pool = core.make_inputs(cfg, mix, seed, device)
    prog = build(cfg, mix, w, seed, device)
    prog.warm(pool)
    outs = [tuple(x if j == 0 else x.cpu() for j, x in enumerate(prog.call(raw))) for raw in pool]
    prog.free()
    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    window = port.Window(len(pool), 0.0, 0.0, [], outs)
    with ref.ieee_f32():
        if kind == "program":
            return numbers(cfg, mix, w, pool, window, None, seed)
        out = {}
        for raw, (log_p, picks) in zip(pool, outs):
            if kind == "fault":
                picks = picks.clone()
                picks[0, 0] = (picks[0, 0] + 1) % picks.new_tensor(cfg["data"]["max_sentences"])
                ref_logp, _ = ref.serve(w["model"], w["vgg"], raw, cfg, feed=picks.to(device))
                got = check.serve_numbers(log_p, picks, ref_logp, raw["sent_mask"],
                                          cfg["model"]["mask_selected"])
            elif kind == "control":
                fed = picks.to(device)
                ctl_logp, _ = ref.serve(w["model"], w["vgg"], raw, cfg, feed=fed, prec=ref.Prec("fp8"))
                ref_logp, _ = ref.serve(w["model"], w["vgg"], raw, cfg, feed=fed)
                got = check.serve_numbers(ctl_logp, ctl_logp.argmax(-1), ref_logp, raw["sent_mask"],
                                          cfg["model"]["mask_selected"], fed=fed)
            else:
                raise ValueError(f"serving has no reading {kind!r}")
            out = check.worst(out, got)
    return out
