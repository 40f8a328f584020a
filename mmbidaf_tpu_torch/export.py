"""Frozen serving artifacts through ``torch.export`` — the port of
``mmbidaf_tpu.export``.

A serving host runs an artifact without the model-building code: the
raw-video → picks program is traced once by ``torch.export`` and saved as
an ``ExportedProgram``, so loading it needs torch, numpy and the custom-op
registrations of the serving kernels (``ops/cuda/registry.py``), and
nothing of ``models``, ``serving`` or ``data.frontend``. The kernels are
custom ops (``torch.ops.mmbidaf.*``), so the traced graph holds one node a
BiLSTM layer, BiDAF block, MFCC or Winograd conv, and the loaded program
launches the same hand kernels as the live ``Summarizer``.

Artifact layout (one directory)::

    decode.pt2       the full-cap program (flat signature, below)
    decode.b{i}.pt2  one program per diagonal bucket level (``buckets``)
    weights.pt       model + frontend tensors once, in their own dtypes,
                     shared by every program (``torch.load(weights_only=True)``)
    manifest.json    sha256 of every file, device, torch version, batch and
                     frame shape, decode mode, raw input specs, weight
                     names and dtypes, compute dtype, the VGG frame chunk
                     traced into each program
    config.json      the run's Config (host-side preprocessing needs it)
    vocab.json       word2idx (host-side transcript encoding)

Each program takes ``(*weight_leaves, *raw_leaves)`` as a flat argument
list and returns ``(log_p, picks)`` as ``make_end_to_end_decode`` does
(beam: the best beam's total log-prob ``[B]`` for ``log_p``). Shapes are
fixed at export, as the JAX package's are. The graph bakes its device into
its factory ops, so an artifact loads only on the device type it was
exported for (JAX's cross-platform lowering has no counterpart). An f32
artifact runs its convolutions in full f32 (``ops.common.full_f32_convs``
around each call), as the live path does: the graph records the
convolutions, not the cuDNN setting the live path pins around them.

Scope: greedy and beam on one device. Top-k (it carries a generator) and
``sp_audio`` are refused as in the JAX package; data-parallel and
tensor-parallel artifacts raise ``NotImplementedError`` (the live
``Summarizer`` runs those layouts; their artifacts are the next slice).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.ops.common import full_f32_convs
from mmbidaf_tpu_torch.ops.cuda import registry  # noqa: F401  (the custom ops a program calls)

_MANIFEST = "manifest.json"
_PROGRAM = "decode.pt2"
_WEIGHTS = "weights.pt"
_CONFIG = "config.json"
_VOCAB = "vocab.json"
_FORMAT_VERSION = 1
_SUPPORTED_VERSIONS = (1,)

# Raw-input call order is pinned by the manifest, not by dict iteration.
_RAW_KEYS = (
    "text_ids", "word_mask", "sent_mask",
    "frames", "img_mask", "waveform", "aud_mask",
)
_MASKS = ("word_mask", "sent_mask", "img_mask", "aud_mask")


class RawSpec(NamedTuple):
    """Shape and numpy dtype of one raw input."""
    shape: tuple
    dtype: np.dtype


def _file_sha256(path: str) -> str:
    """Chunked file hash: a VGG-16 artifact's weights are ~0.3-0.5 GB."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _raw_specs(cfg, batch_size: int, frame_hw: tuple[int, int],
               rungs: Mapping[str, int] | None = None) -> dict[str, RawSpec]:
    """The raw batch ``host_raw_row`` rows stack into (the shapes
    ``Summarizer.warmup`` runs). ``rungs`` overrides the config-cap
    feature-axis sizes (bucketed artifact programs)."""
    d = cfg.data
    b, (h, w) = batch_size, frame_hw
    r = rungs or {}
    t_s = r.get("sentences", d.max_sentences)
    t_w = r.get("words", d.max_words)
    t_i = r.get("keyframes", d.max_keyframes)
    t_a = r.get("audio_frames", d.max_audio_frames)
    n_samples = t_a * d.hop_length + d.win_length
    f32, i32, u8 = np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.uint8)
    return {
        "text_ids": RawSpec((b, t_s, t_w), i32),
        "word_mask": RawSpec((b, t_s, t_w), f32),
        "sent_mask": RawSpec((b, t_s), f32),
        "frames": RawSpec((b, t_i, h, w, 3), u8),
        "img_mask": RawSpec((b, t_i), f32),
        "waveform": RawSpec((b, n_samples), f32),
        "aud_mask": RawSpec((b, t_a), f32),
    }


def _spec_entries(specs: Mapping[str, RawSpec]) -> list[dict]:
    return [{"name": k, "shape": list(specs[k].shape), "dtype": str(specs[k].dtype)}
            for k in _RAW_KEYS]


def _bucket_levels(cfg, buckets) -> list[dict[str, int]]:
    """Diagonal bucket levels, one program each (the full-cap level is the
    main ``decode.pt2`` and is left out; ``serving.bucket_ladder_levels``)."""
    from mmbidaf_tpu_torch.serving import bucket_ladder_levels, serving_bucket_ladders

    return bucket_ladder_levels(serving_bucket_ladders(cfg, buckets))


class _Served(torch.nn.Module):
    """The summarizer's model and frontend under one module, whose forward is
    the serving program on a raw batch."""

    def __init__(self, summ):
        super().__init__()
        self.model = summ.model
        self.frontend = summ.frontend
        self.cfg, self.vgg_spec, self.mode, self.width = summ.cfg, summ.vgg_spec, summ.mode, summ.topk

    def forward(self, raw: dict):
        from mmbidaf_tpu_torch.data.frontend import apply_frontend
        from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode

        batch = apply_frontend(self.frontend, raw, self.cfg, self.vgg_spec)
        return mmbidaf_decode(self.model, batch, self.cfg, mode=self.mode, topk=self.width)


class _FlatProgram(torch.nn.Module):
    """``forward(*weight_leaves, *raw_leaves)``: the weights go in as
    arguments (``functional_call``), as the JAX package's ``flat_fn`` takes
    them, so no program holds a copy of them. The served module sits in a
    list, out of ``torch.export``'s reach as parameters."""

    def __init__(self, served: _Served, names: Sequence[str]):
        super().__init__()
        self._served = [served]
        self.names = list(names)

    def forward(self, *leaves):
        n = len(self.names)
        weights = dict(zip(self.names, leaves[:n]))
        raw = dict(zip(_RAW_KEYS, leaves[n:]))
        return torch.func.functional_call(self._served[0], weights, (raw,), strict=True)


def _example_raw(specs: Mapping[str, RawSpec], device) -> list[torch.Tensor]:
    """A batch at ``specs``' shapes on ``device``: zeros, masks all ones."""
    return [torch.from_numpy((np.ones if k in _MASKS else np.zeros)(specs[k].shape, specs[k].dtype))
            .to(device) for k in _RAW_KEYS]


def export_summarizer(summ, out_dir: str, batch_size: int = 1,
                      frame_hw: tuple[int, int] = (240, 320), buckets=None) -> dict:
    """Export ``summ``'s end-to-end decode (greedy or beam) as an artifact
    for the summarizer's device; returns the manifest.

    ``batch_size`` and ``frame_hw`` are fixed in the program: requests at
    serve time arrive at exactly these shapes (``ExportedSummarizer`` pads
    and chunks them as ``serve_batch_size`` serving does). ``buckets`` (the
    live path's ``serve_buckets``: ``True`` for the quarter/half/full
    ladders, or a ladder dict) also freezes one program per diagonal bucket
    level; ``ExportedSummarizer`` trims each batch to the smallest level
    covering its true lengths."""
    from mmbidaf_tpu_torch.data.frontend import vgg_frame_chunk
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.train.checkpoint import save_config

    if not isinstance(summ, Summarizer):
        raise TypeError(f"expected a Summarizer, got {type(summ).__name__}")
    if summ.mode not in ("greedy", "beam"):
        raise ValueError(
            f"only the deterministic paths export (mode={summ.mode!r}): greedy and beam are pure "
            "functions of weights + raw batch; top-k carries an rng stream — serve it "
            "interactively via Summarizer")
    mesh = summ.cfg.mesh
    if mesh.sp_audio:
        raise ValueError("sp_audio serving programs route through shard_map chains and are not "
                         "exportable; export a non-SP Summarizer")
    if summ._dp_shards != 1 or mesh.tp_vgg or mesh.num_model != 1 or mesh.num_seq != 1:
        raise NotImplementedError("mesh layouts (data-parallel, tp_vgg, num_model, num_seq) in an "
                                  "artifact are the next slice (ROADMAP Queue 1, item 0): artifacts "
                                  "are single-device; the live Summarizer runs the layouts")
    dev = summ.device
    served = _Served(summ)
    named = dict(served.named_parameters())
    named.update(served.named_buffers())
    names = list(named)
    weights = [named[n].detach() for n in names]
    flat = _FlatProgram(served, names)
    cfg = summ.cfg

    def export_program(specs, fname: str) -> dict:
        path = os.path.join(out_dir, fname)
        with torch.no_grad():
            ep = torch.export.export(flat, tuple(weights + _example_raw(specs, dev)), strict=False)
        ep.example_inputs = None  # they hold the weights: weights.pt holds them once
        torch.export.save(ep, path)
        n_frames = specs["frames"].shape[0] * specs["frames"].shape[1]
        return {"file": fname, "raw_inputs": _spec_entries(specs),
                "vgg_frame_chunk": vgg_frame_chunk(cfg, n_frames, summ.vgg_spec, dev)
                if cfg.model.use_images else None}

    os.makedirs(out_dir, exist_ok=True)
    main = export_program(_raw_specs(cfg, batch_size, frame_hw), _PROGRAM)
    bucket_manifest = None
    if buckets:
        bucket_manifest = []
        for i, rungs in enumerate(_bucket_levels(cfg, buckets)):
            entry = export_program(_raw_specs(cfg, batch_size, frame_hw, rungs=rungs),
                                   f"decode.b{i}.pt2")
            bucket_manifest.append({**entry, "rungs": rungs})
    torch.save(dict(zip(names, (w.cpu() for w in weights))), os.path.join(out_dir, _WEIGHTS))
    save_config(out_dir, cfg)
    with open(os.path.join(out_dir, _VOCAB), "w") as f:
        json.dump(summ.word2idx, f)
    files = [_WEIGHTS, _PROGRAM, _CONFIG, _VOCAB] + [e["file"] for e in bucket_manifest or []]
    manifest = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        # the files are opaque binaries with no check of their own pairing: a
        # swapped, corrupted or partly copied file fails at load
        "sha256": {f: _file_sha256(os.path.join(out_dir, f)) for f in files},
        "device": dev.type,
        "batch_size": batch_size,
        "frame_hw": list(frame_hw),
        "compute_dtype": cfg.model.compute_dtype,
        "n_weight_leaves": len(names),
        "weight_names": names,
        "weight_dtypes": [str(w.dtype).removeprefix("torch.") for w in weights],
        "raw_inputs": main["raw_inputs"],
        "vgg_frame_chunk": main["vgg_frame_chunk"],
        # greedy: log_p per step [B, K, T_s]; beam: the best beam's total
        # sequence log-prob [B], its width fixed at export
        "decode_mode": summ.mode,
        "beam_width": summ.topk if summ.mode == "beam" else None,
        "outputs": ["log_p", "picks"],
        "mesh": None,  # single-device program
        "bucket_programs": bucket_manifest,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedDecoder:
    """The device half of an artifact: raw batch in, ``(log_p, picks)`` out.

    Imports torch, numpy and the serving kernels' custom ops, and nothing of
    the model's code, so a serving host runs it without ``models``,
    ``serving`` or ``data.frontend`` (``tests/test_torch_export.py`` proves
    it in a fresh process). Every file's sha256 is checked before anything
    is loaded. Each program runs under ``torch.inference_mode`` and, for an
    f32 artifact, with cuDNN's convolutions pinned to full f32. Dispatches
    hold one lock, so request threads may share a decoder. Host-side
    preprocessing lives in ``ExportedSummarizer``."""

    def __init__(self, artifact_dir: str, device="cuda"):
        with open(os.path.join(artifact_dir, _MANIFEST)) as f:
            self.manifest = m = json.load(f)
        if m.get("format_version") not in _SUPPORTED_VERSIONS:
            raise ValueError(f"artifact format {m.get('format_version')} not in supported "
                             f"{_SUPPORTED_VERSIONS}")
        want = torch.device(device).type
        if want != m["device"]:
            raise ValueError(f"the artifact was exported for device {m['device']!r}; it cannot "
                             f"run on {want!r}: its graph fixes the device (re-export it there)")
        self.device = resolve_device(device)
        for fname, digest in m["sha256"].items():
            if _file_sha256(os.path.join(artifact_dir, fname)) != digest:
                raise ValueError(f"{fname} does not match the manifest's sha256 — the artifact is "
                                 "corrupted or its files were mixed from different exports; "
                                 "re-export or re-copy it")
        tensors = torch.load(os.path.join(artifact_dir, _WEIGHTS), weights_only=True,
                             map_location=self.device)
        names = m["weight_names"]
        if len(names) != m["n_weight_leaves"] or set(names) != set(tensors):
            raise ValueError("the manifest's weight names do not match weights.pt — corrupted or "
                             "mixed artifact")
        self._weights = [tensors[n] for n in names]
        for n, w, dt in zip(names, self._weights, m["weight_dtypes"]):
            if str(w.dtype).removeprefix("torch.") != dt:
                raise ValueError(f"weight {n!r} is {w.dtype}, the manifest says {dt}")
        self.batch_size = m["batch_size"]
        self.frame_hw = tuple(m["frame_hw"])
        self.decode_mode = m["decode_mode"]
        self.compute_dtype = m["compute_dtype"]
        # smallest level first by feature volume: _stack_rows takes the
        # FIRST covering level, so the manifest's entry order must not decide
        buckets = sorted(m.get("bucket_programs") or [],
                         key=lambda e: int(np.prod(list(e["rungs"].values()))))
        self._programs = [{"file": _PROGRAM, "raw_inputs": m["raw_inputs"], "rungs": None}]
        self._programs += [dict(e) for e in buckets]
        for prog in self._programs:
            prog["run"] = torch.export.load(os.path.join(artifact_dir, prog["file"])).module()
        self.bucket_levels = [e["rungs"] for e in buckets]
        self._lock = threading.Lock()

    def _select_program(self, raw: Mapping) -> dict:
        """The program whose input shapes match ``raw`` exactly."""
        for prog in self._programs:
            if all(s["name"] in raw and tuple(raw[s["name"]].shape) == tuple(s["shape"])
                   for s in prog["raw_inputs"]):
                return prog
        missing = [s["name"] for s in self.manifest["raw_inputs"] if s["name"] not in raw]
        if missing:
            raise KeyError(f"raw batch is missing {missing[0]!r}")
        got = {s["name"]: tuple(raw[s["name"]].shape) for s in self.manifest["raw_inputs"]}
        options = [{s["name"]: tuple(s["shape"]) for s in prog["raw_inputs"]}
                   for prog in self._programs]
        raise ValueError(f"raw batch shapes {got} match none of the artifact's programs: {options} "
                         "(batch_size/frame_hw/bucket rungs are fixed at export — re-export for "
                         "other shapes)")

    def _arg(self, arr, spec: dict) -> torch.Tensor:
        """One raw input on the device in its spec's dtype: a host array is
        cast on the host and uploaded once; a tensor already on the device
        stays there."""
        if isinstance(arr, torch.Tensor):
            dtype = getattr(torch, spec["dtype"])
            return arr.to(self.device, dtype)
        arr = np.ascontiguousarray(np.asarray(arr, dtype=spec["dtype"]))
        return torch.from_numpy(arr).to(self.device)

    def run(self, raw: Mapping) -> tuple[torch.Tensor, torch.Tensor]:
        """Dispatch the program matching the batch's shapes → ``(log_p,
        picks)`` on the device, without waiting for them."""
        prog = self._select_program(raw)
        args = [self._arg(raw[s["name"]], s) for s in prog["raw_inputs"]]
        dtype = torch.float32 if self.compute_dtype == "float32" else None
        with self._lock, torch.inference_mode(), full_f32_convs(dtype):
            return prog["run"](*self._weights, *args)

    def decode_raw(self, raw: Mapping) -> tuple[np.ndarray, np.ndarray]:
        """Run the program matching the batch's shapes → numpy ``(log_p, picks)``."""
        log_p, picks = self.run(raw)
        return log_p.cpu().numpy(), picks.cpu().numpy()

    def warmup(self) -> None:
        """One batch per program (full-cap and every bucket level): the
        kernel library's load, each shape's kernel plans and occupancy
        checks and cuDNN's algorithm choice happen here, not on the first
        request."""
        for prog in self._programs:
            self.decode_raw({s["name"]: (np.ones if s["name"] in _MASKS else np.zeros)(
                s["shape"], s["dtype"]) for s in prog["raw_inputs"]})


class ExportedSummarizer:
    """Full serving from an artifact: video dirs in, summary text out.

    Pairs ``ExportedDecoder`` with the port's host-side preprocessing
    (``serving.host_raw_row``) and summary assembly; behaves like
    ``Summarizer.summarize_batch`` with ``serve_batch_size`` = the artifact's
    batch (requests padded by repeating the last video, chunked to the fixed
    shape). Shares the private surface ``DynamicBatcher`` reads with
    ``Summarizer``."""

    _dp_shards = 1  # a single-device program

    def __init__(self, artifact_dir: str, device="cuda"):
        from mmbidaf_tpu_torch.config import config_from_json

        self.decoder = ExportedDecoder(artifact_dir, device)
        self.cfg = config_from_json(os.path.join(artifact_dir, _CONFIG))
        with open(os.path.join(artifact_dir, _VOCAB)) as f:
            self.word2idx = json.load(f)
        # rung tuple -> device batches (the live Summarizer.bucket_stats;
        # empty on a single-shape artifact)
        self.bucket_stats: dict[tuple, int] = {}
        self._stats_lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return self.decoder.device

    @property
    def mode(self) -> str:
        return self.decoder.decode_mode

    @property
    def fixed_batch_size(self) -> int:
        """The artifact's batch: a batcher must match it."""
        return self.decoder.batch_size

    @property
    def bucket_levels(self) -> list:
        """The frozen rung levels, smallest first."""
        return self.decoder.bucket_levels

    def _check_hw(self, video_dir: str, frames: np.ndarray) -> None:
        hw = tuple(frames.shape[1:3])
        if hw != self.decoder.frame_hw:
            raise ValueError(f"{video_dir}: decoded frames are {hw}, the artifact was exported "
                             f"for frame_hw={self.decoder.frame_hw}")

    def _raw_row(self, video_dir: str) -> tuple[dict, list[str]]:
        from mmbidaf_tpu_torch.serving import host_raw_row

        row, sents = host_raw_row(video_dir, self.word2idx, self.cfg)
        self._check_hw(video_dir, row["frames"])
        return row, sents

    def _stack_rows(self, rows: Sequence[dict]) -> dict:
        """Stack rows into one batch; on a bucketed artifact trim them first
        to the smallest frozen level covering the batch's true lengths (the
        full-cap program where none does)."""
        from mmbidaf_tpu_torch.serving import (batch_true_lengths, covering_level,
                                               record_bucket_stat, trim_raw_to_rungs)

        levels = self.decoder.bucket_levels
        if levels:
            needs: dict[str, int] = {}
            for r in rows:
                for k, v in batch_true_lengths(r).items():
                    needs[k] = max(needs.get(k, 0), v)
            lvl = covering_level(levels, needs)
            if lvl >= 0:
                rows = [trim_raw_to_rungs(r, self.cfg, levels[lvl], batched=False) for r in rows]
        raw = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        if levels:
            record_bucket_stat(self.bucket_stats, self._stats_lock, raw)
        return raw

    def _decode_batch_device(self, raw, generator=None):
        """Dispatch one batch → ``(log_p, picks)`` on the device."""
        return self.decoder.run(raw)

    def _raw_chunk(self, chunk: list[str]) -> tuple[dict, list[list[str]]]:
        """Host-decode one chunk, padded by reusing the last decoded row."""
        rows, sentences = [], []
        for vd in chunk:
            row, sents = self._raw_row(vd)
            rows.append(row)
            sentences.append(sents)
        rows += [rows[-1]] * (self.decoder.batch_size - len(rows))
        return self._stack_rows(rows), sentences

    def summarize_batch(self, video_dirs: Sequence[str]) -> list[str]:
        from concurrent.futures import ThreadPoolExecutor

        from mmbidaf_tpu_torch.train.metrics import summary_from_picks

        if not video_dirs:
            return []
        sb = self.decoder.batch_size
        chunks = [list(video_dirs[s:s + sb]) for s in range(0, len(video_dirs), sb)]
        out: list[str] = []
        # chunk i+1's host decode overlaps chunk i's program
        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = ex.submit(self._raw_chunk, chunks[0])
            for i, chunk in enumerate(chunks):
                raw, sentences = pending.result()
                if i + 1 < len(chunks):
                    pending = ex.submit(self._raw_chunk, chunks[i + 1])
                _, picks = self.decoder.decode_raw(raw)
                out.extend(summary_from_picks(picks[j], sentences[j]) for j in range(len(chunk)))
        return out

    def summarize(self, video_dir: str) -> str:
        return self.summarize_batch([video_dir])[0]

    def summarize_long(self, video_dir: str, stride: int | None = None) -> str:
        """Windowed serving past the ``max_sentences`` bucket over the frozen
        program (``Summarizer.summarize_long``: overlapping sentence windows
        share the video's media, per-window picks merge by score). The
        program's inputs are raw media, so every window chunk carries and
        featurizes the same media rows again: the live path's
        featurize-once shortcut cannot exist inside a frozen program."""
        from mmbidaf_tpu_torch.data.text import encode_sentences, sent_tokenize
        from mmbidaf_tpu_torch.data.video import audio_frames_valid, load_video_assets
        from mmbidaf_tpu_torch.serving import (merge_window_picks, num_audio_samples,
                                               picks_scores, transcript_windows)
        from mmbidaf_tpu_torch.train.metrics import summary_from_picks

        d, m = self.cfg.data, self.cfg.model
        assets = load_video_assets(video_dir, d.max_keyframes, num_audio_samples(self.cfg),
                                   keyframe_policy=d.keyframe_policy, sample_rate=d.sample_rate)
        self._check_hw(video_dir, assets["frames"])
        sentences = sent_tokenize(assets["transcript"])
        n_aud = audio_frames_valid(assets["valid_samples"], d.hop_length, d.max_audio_frames)
        media = {
            "frames": assets["frames"],
            "img_mask": assets["img_mask"],
            "waveform": assets["waveform"],
            "aud_mask": (np.arange(d.max_audio_frames) < n_aud).astype(np.float32),
        }

        def window_row(sents):
            enc = encode_sentences(sents, self.word2idx, d.max_sentences, d.max_words)
            return {"text_ids": enc["text_ids"], "word_mask": enc["word_mask"],
                    "sent_mask": enc["sent_mask"], **media}

        sb = self.decoder.batch_size

        def decode_rows(rows):
            """Pad to the artifact's batch and decode one chunk."""
            n_real = len(rows)
            log_p, picks = self.decoder.decode_raw(self._stack_rows(rows + [rows[-1]] * (sb - n_real)))
            return picks[:n_real], picks_scores(log_p, picks)[:n_real]

        if len(sentences) <= d.max_sentences:
            picks, _ = decode_rows([window_row(sentences)])
            return summary_from_picks(picks[0], sentences)
        stride = stride or max(d.max_sentences // 2, 1)
        starts = transcript_windows(len(sentences), d.max_sentences, stride)
        rows = [window_row(sentences[st:st + d.max_sentences]) for st in starts]
        picks_l, scores_l = [], []
        for i in range(0, len(rows), sb):
            p, s = decode_rows(rows[i:i + sb])
            picks_l.append(p)
            scores_l.append(s)
        window_lens = [min(d.max_sentences, len(sentences) - st) for st in starts]
        chosen = merge_window_picks(np.concatenate(picks_l), np.concatenate(scores_l), starts,
                                    window_lens, m.max_decode_steps)
        return " ".join(sentences[g] for g in chosen)

    def warmup(self) -> None:
        self.decoder.warmup()
