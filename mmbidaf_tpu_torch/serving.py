"""Serving API of the port: video asset directories in, summary text out.

    s = Summarizer.init_random(cfg, seed=0, device="cuda")
    s = Summarizer.from_jax_params(params_np, fe_np, word2idx, cfg, device="cuda")
    s = Summarizer.from_run(run_dir, seed=cfg.train.seed)  # a train.cli run
    s = Summarizer.from_run(run_dir, mode="beam", topk=4, serve_buckets=True)
    s.warmup((240, 320), batch_size=8)      # before the first request
    summaries = s.summarize_batch([video_dir1, video_dir2])
    summary = s.summarize(video_dir)
    summary = s.summarize_long(video_dir)   # transcripts past max_sentences
    with DynamicBatcher(s, max_batch_size=8) as b:  # many request threads
        summary = b.submit(video_dir)

The device side is ``data.frontend.make_end_to_end_decode`` (frontend +
model + greedy decode), or ``apply_frontend`` + ``mmbidaf_decode`` for
``mode="beam"`` and ``mode="topk"``; host work is asset decode and summary
assembly, through the port's own copies of the JAX package's host modules.
Batches go up through pinned memory on a side stream
(``data.prefetch.batch_uploader``) and picks come back through pinned
memory behind an event (``HostFetch``), so a thread that dispatches does
not wait on the card.

``serve_buckets`` trims each batch's four ragged axes to the smallest rung
of a ladder covering its true lengths (the masks carry them, so the answer
does not change) before the upload; ``summarize_long`` featurizes a video's
media once, trimmed likewise, and decodes overlapping transcript windows
against it. ``DynamicBatcher`` coalesces concurrent requests into device
batches.

Mesh layouts (``parallel/``, one process a device under ``torchrun``):
``data_parallel=True`` decodes each rank's rows of every batch, which every
rank is given whole, and all-gathers the picks; ``MeshConfig.tp_vgg`` splits
the VGG classifier over ``model``; ``MeshConfig.sp_audio`` runs the audio
tower sequence-parallel over ``seq``. Every rank returns every answer. A
server takes requests on rank 0 only: ``lead`` gives rank 0's summarizer a
``MeshFeed``, which sends every device call (its kind, then its arrays by
``dist.broadcast``) to the other ranks before rank 0 runs it, and ``follow``
runs them there, so every rank joins the same collectives in the same
order; ``MeshFeed.stop`` ends the followers.

Threads: every dispatch to the card, and top-k's draws from its generator,
hold the summarizer's lock, so one ``Summarizer`` may be shared by request
threads; the kernels' Python launch counters and plan caches are then only
touched by one thread at a time.
"""

from __future__ import annotations

import queue as _queue_mod
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Mapping, Sequence

import numpy as np
import torch

from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.data.frontend import (
    Frontend,
    apply_frontend,
    cast_vgg_weights,
    frontend_init,
    make_end_to_end_decode,
)
from mmbidaf_tpu_torch.data.pipeline import bucket_for, default_axis_buckets
from mmbidaf_tpu_torch.data.prefetch import InFlight, batch_uploader
from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
from mmbidaf_tpu_torch.data.text import encode_sentences, encode_transcript, sent_tokenize
from mmbidaf_tpu_torch.data.video import audio_frames_valid, load_video_assets
from mmbidaf_tpu_torch.models.mmbidaf import MMBiDAF, mmbidaf_decode, mmbidaf_init
from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC
from mmbidaf_tpu_torch.train.metrics import summary_from_picks

AXES = ("sentences", "words", "keyframes", "audio_frames")


class ServerOverloadedError(RuntimeError):
    """Raised by ``DynamicBatcher.submit`` when the pending-request queue
    holds ``max_queue`` requests: callers shed load (HTTP 503) instead of
    letting the backlog grow host memory and tail latency."""


def transcript_windows(n_sents: int, window: int, stride: int) -> list[int]:
    """Window start indices covering ``n_sents`` sentences: strided starts
    plus a tail window so the last sentences are never dropped."""
    if n_sents <= window:
        return [0]
    starts = list(range(0, n_sents - window, stride))
    starts.append(n_sents - window)
    return starts


def merge_window_picks(picks: np.ndarray, scores: np.ndarray, starts: Sequence[int],
                       window_lens: Sequence[int], k: int) -> list[int]:
    """Merge per-window pointer picks ``[W, K]`` (window-local indices, with
    per-pick ``scores``) into one global selection: picks on padded slots
    are dropped, a sentence picked by overlapping windows keeps its best
    score, and the top ``k`` return in transcript order."""
    best: dict[int, float] = {}
    for w, start in enumerate(starts):
        for j in range(picks.shape[1]):
            local = int(picks[w, j])
            if local >= window_lens[w]:
                continue
            g = start + local
            s = float(scores[w, j])
            if g not in best or s > best[g]:
                best[g] = s
    top = sorted(best, key=lambda g: -best[g])[:k]
    return sorted(top)


def picks_scores(log_p: np.ndarray, picks: np.ndarray) -> np.ndarray:
    """Per-pick merge scores ``[B, K]``: greedy and top-k give per-step
    log-probs ``[B, K, T_s]``, gathered at each pick; beam gives the best
    beam's total log-prob ``[B]``, broadcast to its picks (it ranks whole
    windows)."""
    if log_p.ndim == 1:
        return np.broadcast_to(log_p[:, None], picks.shape)
    return np.take_along_axis(log_p, picks[:, :, None], axis=2)[:, :, 0]


def num_audio_samples(cfg: Config) -> int:
    """Waveform samples needed to fill the ``max_audio_frames`` bucket."""
    d = cfg.data
    return d.max_audio_frames * d.hop_length + d.win_length


def serving_bucket_ladders(cfg: Config, buckets=True) -> dict[str, tuple[int, ...]]:
    """``Summarizer(serve_buckets=…)`` as per-axis ladders: ``True`` gives the
    quarter/half/full ladders (``default_axis_buckets``) on all four ragged
    axes, a non-empty dict explicit ladders by axis (``suggest_buckets``'
    output), the others defaulted. The config cap ends every ladder: a
    request past the top rung pads up to the cap and is never cut. Under
    ``MeshConfig.sp_audio`` the audio rungs round up to ``num_seq``
    multiples, as ``bucketed_iterator(seq_align=…)`` does."""
    d = cfg.data
    caps = dict(zip(AXES, (d.max_sentences, d.max_words, d.max_keyframes, d.max_audio_frames)))
    if buckets is True:
        given = {}
    elif isinstance(buckets, dict) and buckets:
        given = dict(buckets)
    else:
        # a tuple probably meant one ladder and an empty dict an empty
        # suggest_buckets result: both fail instead of serving defaults
        raise ValueError("serve_buckets must be True (default ladders) or a non-empty dict of "
                         f"per-axis ladders (suggest_buckets output); got {buckets!r}")
    unknown = sorted(set(given) - set(caps))
    if unknown:
        raise ValueError(f"unknown serve_buckets axes {unknown}: expected a subset of {sorted(caps)}")
    out = {}
    for key, cap in caps.items():
        ladder = given.get(key)
        rungs = {int(b) for b in (default_axis_buckets(cap) if ladder is None else ladder)}
        if any(b < 1 for b in rungs):
            raise ValueError(f"serve_buckets[{key!r}] has rungs < 1: {sorted(rungs)}")
        out[key] = tuple(sorted({min(b, cap) for b in rungs} | {cap}))
    if cfg.mesh.sp_audio and cfg.mesh.num_seq > 1:
        ns, cap = cfg.mesh.num_seq, caps["audio_frames"]
        if cap % ns:
            raise ValueError(f"max_audio_frames {cap} must be a multiple of MeshConfig.num_seq "
                             f"{ns} to bucket the audio axis under sp_audio")
        out["audio_frames"] = tuple(sorted({min(-(-b // ns) * ns, cap) for b in out["audio_frames"]}))
    return out


def bucket_ladder_levels(ladders: Mapping[str, tuple]) -> list[dict[str, int]]:
    """Diagonal rung levels of a ladder set, smallest first: the rungs of
    every axis at the same index (a shorter ladder clamps to its top), the
    all-caps level left out. ``warmup`` runs each, and ``DynamicBatcher``
    groups requests by the one covering them."""
    n_levels = max(len(v) for v in ladders.values())
    caps = {k: v[-1] for k, v in ladders.items()}
    levels, seen = [], set()
    for i in range(n_levels):
        rung = {k: v[min(i, len(v) - 1)] for k, v in ladders.items()}
        key = tuple(sorted(rung.items()))
        if rung == caps or key in seen:
            continue
        seen.add(key)
        levels.append(rung)
    return levels


def covering_level(levels: Sequence[Mapping[str, int]], needs: Mapping[str, int]) -> int:
    """Index of the smallest level covering ``needs``, or -1 for the caps. A
    level without one of the needed axes never covers."""
    for i, rungs in enumerate(levels):
        if all(rungs.get(k, 0) >= v for k, v in needs.items()):
            return i
    return -1


def batch_true_lengths(raw: Mapping[str, np.ndarray]) -> dict[str, int]:
    """True lengths by axis of a stacked batch or of one row, from its prefix
    masks (each mask's last axis is the counted one; at least 1 for a
    present axis: an empty transcript still needs a slot)."""
    out = {}
    if "sent_mask" in raw:
        out["sentences"] = max(int(raw["sent_mask"].sum(axis=-1).max()), 1)
        out["words"] = max(int(raw["word_mask"].sum(axis=-1).max()), 1)
    if "img_mask" in raw:
        out["keyframes"] = max(int(raw["img_mask"].sum(axis=-1).max()), 1)
    if "aud_mask" in raw:
        out["audio_frames"] = max(int(raw["aud_mask"].sum(axis=-1).max()), 1)
    return out


def covering_rungs(needs: Mapping[str, int], ladders: Mapping[str, tuple]) -> dict[str, int]:
    """Each axis' smallest rung holding its need; absent axes (disabled
    towers) get a placeholder 0, which ``trim_raw_to_rungs`` never reads."""
    rungs = {k: bucket_for(v, ladders[k]) for k, v in needs.items()}
    for k in AXES:
        rungs.setdefault(k, 0)
    return rungs


def record_bucket_stat(stats: dict, lock, raw: Mapping[str, np.ndarray]) -> None:
    """Count one device batch under its rung tuple (T_s, W, T_img, T_aud)."""
    key = tuple(raw[k].shape[-1] for k in ("sent_mask", "word_mask", "img_mask", "aud_mask")
                if k in raw)
    with lock:
        stats[key] = stats.get(key, 0) + 1


def trim_raw_to_rungs(raw: dict, cfg: Config, rungs: Mapping[str, int], batched: bool = True) -> dict:
    """Slice a batch's (``batched=False``: one row's) ragged axes to the
    given rungs, raw (``frames``, ``waveform``) or featurized (``images``,
    ``audio``); keys that are absent pass. The caller's rungs cover the true
    lengths, so nothing a mask keeps is cut. The waveform keeps
    ``frames · hop + win`` samples, the frontend's frame count relation."""
    d = cfg.data
    pre = (slice(None),) if batched else ()
    out = dict(raw)
    if "sent_mask" in raw:
        bs, bw = rungs["sentences"], rungs["words"]
        out["text_ids"] = raw["text_ids"][pre + (slice(bs), slice(bw))]
        out["word_mask"] = raw["word_mask"][pre + (slice(bs), slice(bw))]
        out["sent_mask"] = raw["sent_mask"][pre + (slice(bs),)]
    if "img_mask" in raw:
        bi = rungs["keyframes"]
        for k in ("frames", "images", "img_mask"):
            if k in raw:
                out[k] = raw[k][pre + (slice(bi),)]
    if "aud_mask" in raw:
        ba = rungs["audio_frames"]
        if "waveform" in raw:
            out["waveform"] = raw["waveform"][pre + (slice(ba * d.hop_length + d.win_length),)]
        for k in ("audio", "aud_mask"):
            if k in raw:
                out[k] = raw[k][pre + (slice(ba),)]
    return out


def trim_raw_batch(raw: dict, cfg: Config, ladders: Mapping[str, tuple]) -> dict:
    """Trim a stacked batch to the smallest rungs covering its true lengths,
    each axis on its own."""
    return trim_raw_to_rungs(raw, cfg, covering_rungs(batch_true_lengths(raw), ladders))


def host_raw_row(video_dir: str, word2idx: dict[str, int], cfg: Config) -> tuple[dict, list[str]]:
    """Host-decode ONE video's assets into an (unstacked) numpy raw row — the
    seven arrays ``make_end_to_end_decode`` consumes — plus the transcript
    sentences for assembling the summary."""
    d = cfg.data
    assets = load_video_assets(
        video_dir, d.max_keyframes, num_audio_samples(cfg),
        keyframe_policy=d.keyframe_policy, sample_rate=d.sample_rate,
    )
    enc = encode_transcript(assets["transcript"], word2idx, d.max_sentences, d.max_words)
    n_aud = audio_frames_valid(assets["valid_samples"], d.hop_length, d.max_audio_frames)
    row = {
        "text_ids": enc["text_ids"],
        "word_mask": enc["word_mask"],
        "sent_mask": enc["sent_mask"],
        "frames": assets["frames"],
        "img_mask": assets["img_mask"],
        "waveform": assets["waveform"],
        "aud_mask": (np.arange(d.max_audio_frames) < n_aud).astype(np.float32),
    }
    return row, enc["sentences"]


class HostFetch:
    """A device tensor's copy to the host, started at once: into pinned
    memory on the current stream, without blocking, an event behind it, so
    ``numpy()`` waits for this copy alone and not for work queued after it.
    On the CPU, the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        """The values; a fault of the work before the copy raises here."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class MeshFeed:
    """Rank 0 of a serving mesh → the other ranks: each device call, as a
    header (``broadcast_object_list``: the kind — ``"decode"``,
    ``"featurize"`` or ``"stop"`` —, each array's name, shape and dtype, and
    the state of the caller's generator when it passed one), then each array
    by ``dist.broadcast`` from the caller's device (the card under NCCL, the
    CPU under gloo). Rank 0 sends under the summarizer's lock, right before
    its own call, so the calls reach every rank in one order."""

    def __init__(self, device):
        self.device = torch.device(device)

    def send(self, kind: str, arrays: Mapping[str, torch.Tensor] | None = None,
             generator: torch.Generator | None = None) -> None:
        import torch.distributed as dist

        arrays = {k: v.contiguous() for k, v in (arrays or {}).items()}
        header = {"kind": kind,
                  "arrays": [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
                             for k, v in arrays.items()],
                  "gen_state": None if generator is None else generator.get_state()}
        dist.broadcast_object_list([header], src=0)
        for v in arrays.values():
            dist.broadcast(v, src=0)

    def recv(self) -> tuple[str, dict, torch.Tensor | None]:
        """``(kind, arrays, gen_state)`` of rank 0's next call."""
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0)
        header = box[0]
        arrays = {}
        for k, shape, dtype in header["arrays"]:
            arrays[k] = torch.empty(shape, dtype=getattr(torch, dtype), device=self.device)
            dist.broadcast(arrays[k], src=0)
        return header["kind"], arrays, header["gen_state"]

    def stop(self) -> None:
        self.send("stop")


def lead(summarizer) -> MeshFeed | None:
    """Rank 0 of a serving daemon under a process group: every device call
    of ``summarizer`` (a ``Summarizer`` or an ``ExportedSummarizer``) is sent
    to the other ranks first. None (nothing set) without a group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    summarizer.feed = MeshFeed(summarizer.device)
    return summarizer.feed


def follow(summarizer, log=print) -> int:
    """A rank past 0 of a serving daemon: run each device call rank 0 sends,
    until it sends ``stop``; returns the calls run. A call that fails here
    is logged and the loop goes on (rank 0 answers for it)."""
    feed = MeshFeed(summarizer.device)
    n = 0
    while True:
        kind, arrays, gen_state = feed.recv()
        if kind == "stop":
            return n
        try:
            summarizer.follow(kind, arrays, gen_state)
        except Exception as e:  # noqa: BLE001 - rank 0 reports the request's failure
            log(f"follow: {kind} failed on this rank: {type(e).__name__}: {e}")
        n += 1


class Summarizer:
    # rank 0 of a serving daemon: sends each device call to the other ranks
    feed: MeshFeed | None = None

    def __init__(
        self,
        model: MMBiDAF,
        frontend: Frontend,
        word2idx: dict[str, int],
        cfg: Config,
        vgg_spec=VGG16_SPEC,
        mode: str = "greedy",
        topk: int = 4,
        seed: int = 0,
        serve_batch_size: int | None = None,
        data_parallel: bool = False,
        serve_buckets=None,
    ):
        if mode not in ("greedy", "beam", "topk"):
            # a typo ("greddy") must not silently become sampling
            raise ValueError(f"unknown decode mode {mode!r}: expected 'greedy', 'beam', or 'topk'")
        if serve_batch_size is not None and serve_batch_size < 1:
            raise ValueError(f"serve_batch_size must be >= 1, got {serve_batch_size}")
        self.device = model.embedding.table.device  # raw batches go where the weights are
        self.model = model
        # frozen VGG weights held in the compute dtype
        self.frontend = cast_vgg_weights(frontend, cfg.model.compute_dtype)
        self.word2idx = word2idx
        self.cfg = cfg
        self.vgg_spec = vgg_spec
        self.mode = mode
        self.topk = topk
        # Static serving batch: requests are padded up (and chunked) to it.
        self.serve_batch_size = serve_batch_size
        # serve_buckets (None or False: off): ladders per ragged axis; each
        # batch is trimmed to the rungs covering its true lengths before the
        # upload. Every distinct rung tuple is a new shape for the kernels,
        # whose plans and occupancy checks are cached per shape.
        self._ladders = (None if serve_buckets is None or serve_buckets is False
                         else serving_bucket_ladders(cfg, serve_buckets))
        self.bucket_levels = bucket_ladder_levels(self._ladders) if self._ladders else []
        self.bucket_stats: dict[tuple, int] = {}  # rung tuple -> device batches
        self._stats_lock = threading.Lock()
        self._mesh_layout(data_parallel)
        # held by every dispatch to the device and by top-k's draws
        self._lock = threading.Lock()
        self._generator = (torch.Generator(self.device).manual_seed(seed)
                           if mode == "topk" else None)
        self._upload = batch_uploader(self.device)
        g_fn = self._audio_g_fn
        if mode == "greedy":
            greedy = make_end_to_end_decode(cfg, vgg_spec, audio_g_fn=g_fn)
            decode = lambda model, fe, raw, generator, rows=None: greedy(model, fe, raw)  # noqa: E731
        else:
            @torch.inference_mode()
            def decode(model, fe, raw, generator, rows=None):
                batch = apply_frontend(fe, raw, cfg, vgg_spec, sp_audio=g_fn is not None)
                return mmbidaf_decode(model, batch, cfg, mode=mode, topk=topk, generator=generator,
                                      audio_g_fn=g_fn, rows=rows)

        self._decode = self._data_parallel(decode) if self._dp else decode

    def _mesh_layout(self, data_parallel: bool) -> None:
        """The mesh layouts, as the JAX ``Summarizer`` checks and builds them:
        ``data_parallel`` (each rank decodes its rows of every batch, which
        every rank is given whole, then the picks are all-gathered in
        order), ``MeshConfig.tp_vgg`` (the VGG classifier split over
        ``model``) and ``MeshConfig.sp_audio`` (the sequence-parallel audio
        tower over ``seq``; under DP on the rank's rows, else on the whole
        request batch)."""
        cfg = self.cfg
        self._mesh = self._audio_g_fn = None
        self._dp = bool(data_parallel)
        self._dp_shards = 1
        sp_on = cfg.mesh.sp_audio and cfg.model.use_audio
        tp_on = cfg.mesh.tp_vgg
        if tp_on and not cfg.model.use_images:
            raise ValueError("tp_vgg shards the VGG classifier but the image tower is disabled "
                             "(use_images=False)")
        if not (sp_on or self._dp or tp_on):
            return
        from mmbidaf_tpu_torch.parallel.mesh import (data_shard_count, make_mesh, shard_frontend,
                                                     shard_params)

        self._mesh = make_mesh(cfg.mesh, self.device)
        if self._dp:
            n = data_shard_count(self._mesh)
            if self.serve_batch_size is None or self.serve_batch_size % n != 0:
                raise ValueError(f"data_parallel serving shards the batch over {n} device(s): "
                                 f"pass serve_batch_size as a multiple of {n} "
                                 f"(got {self.serve_batch_size!r})")
            self._dp_shards = n
        if self._dp or tp_on:
            self.model = shard_params(self.model, self._mesh)
            self.frontend = shard_frontend(self.frontend, self._mesh, tp_on)
        if sp_on:
            from mmbidaf_tpu_torch.parallel.sp_tower import make_sp_audio_tower

            self._audio_g_fn = make_sp_audio_tower(self._mesh, cfg, use_batch_axis=self._dp)

    def _data_parallel(self, decode):
        """``decode`` on this rank's rows of the batch, then every rank's
        log-probs and picks gathered in row order. A batch the data axes do
        not divide (``summarize_long``'s B=1 decodes) runs whole on every rank."""
        from mmbidaf_tpu_torch.parallel.mesh import _data_axes, all_gather, batch_rows

        group = self._mesh.group(_data_axes(self._mesh))

        def dp_decode(model, fe, raw, generator, rows=None):
            b = next(iter(raw.values())).shape[0]
            mine = batch_rows(self._mesh, b)
            if mine is None:
                return decode(model, fe, raw, generator)
            start, stop = mine
            log_p, picks = decode(model, fe, {k: v[start:stop] for k, v in raw.items()},
                                  generator, rows=(start, stop, b))
            return all_gather(log_p, group), all_gather(picks, group)

        return dp_decode

    # -- constructors -------------------------------------------------------

    @classmethod
    def init_random(cls, cfg: Config, seed: int = 0, vgg_spec=VGG16_SPEC, device="cuda", **kw):
        """Untrained summarizer with seeded random weights (smoke tests)."""
        wv = random_word_vectors(np.random.default_rng(seed), cfg.data.vocab_size,
                                 cfg.model.emb_dim)
        word2idx = {f"w{i}": i for i in range(cfg.data.vocab_size)}
        model = mmbidaf_init(cfg, wv, device, seed=seed)
        fe = frontend_init(cfg, vgg_spec, device, seed=seed + 1)
        return cls(model, fe, word2idx, cfg, vgg_spec, **kw)

    @classmethod
    def from_jax_params(cls, params: dict, fe_params: dict, word2idx: dict[str, int],
                        cfg: Config, vgg_spec=VGG16_SPEC, device="cuda", **kw):
        """Serve the JAX package's weights, given as numpy pytrees."""
        from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, model_from_jax

        model = model_from_jax(params, cfg, device)
        fe = frontend_from_jax(fe_params, cfg, vgg_spec, device)
        return cls(model, fe, word2idx, cfg, vgg_spec, **kw)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, vocab_path: str, emb_path: str, cfg: Config,
                        vgg_spec=VGG16_SPEC, seed: int = 0, use_ema: bool = True,
                        device="cuda", **kw):
        """Serve the newest checkpoint of a port-trained run with the run's
        vocabulary (``vocab.json`` / ``emb.npz``). ``use_ema=True`` serves the
        EMA shadow, the reference's eval convention. The frozen frontend is
        seeded from ``seed + 2``: a run trained on random VGG weights seeded
        them from ``cfg.train.seed + 2``, so pass ``seed=cfg.train.seed`` to
        serve through the VGG the run trained with."""
        from mmbidaf_tpu_torch.data.vocab import load_vocab
        from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager
        from mmbidaf_tpu_torch.train.loop import init_train_state

        word2idx, table = load_vocab(vocab_path, emb_path)
        model = mmbidaf_init(cfg, table, device, seed=seed)
        # the weights alone: a run saved on another device serves here too
        restored = init_train_state(model, cfg, seed=seed + 1)
        if CheckpointManager(ckpt_dir).warm_start(restored) is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        fe = frontend_init(cfg, vgg_spec, device, seed=seed + 2)
        served = restored.ema_params if use_ema else restored.params
        return cls(served, fe, word2idx, cfg, vgg_spec, **kw)

    @classmethod
    def from_torch_state_dict(cls, sd: Mapping, word2idx: dict[str, int], cfg: Config,
                              vgg_spec=VGG16_SPEC, seed: int = 0, device="cuda", **kw):
        """Serve the reference's own weights (SURVEY §4.5): its torch
        ``state_dict`` (tensors or numpy arrays) mapped straight into the
        port's model (``interop/torch_port.py``). The frozen frontend is
        seeded from ``seed + 2``, as ``from_checkpoint`` seeds it."""
        from mmbidaf_tpu_torch.interop.torch_port import model_from_state_dict

        model = model_from_state_dict(sd, cfg, device)
        fe = frontend_init(cfg, vgg_spec, device, seed=seed + 2)
        return cls(model, fe, word2idx, cfg, vgg_spec, **kw)

    @classmethod
    def from_run(cls, run_dir: str, mesh_overrides: dict | None = None, **kw):
        """Serve a ``train.cli`` run directory: its saved config (with the
        frontend's VGG variant), vocabulary and newest checkpoint.
        ``from_checkpoint``'s keywords pass through (``seed``, ``device``,
        ``use_ema``, ``vgg_spec`` …)."""
        import os

        from mmbidaf_tpu_torch.ops.vgg import spec_for_variant
        from mmbidaf_tpu_torch.train.checkpoint import load_config

        cfg = load_config(run_dir)
        if mesh_overrides:
            import dataclasses

            # serving hardware rarely matches training hardware: the layout
            # is a deploy-time choice (e.g. {"tp_vgg": True, "num_model": 2})
            cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, **mesh_overrides))
        vgg_spec = kw.pop("vgg_spec", None) or spec_for_variant(cfg.model.vgg_variant)
        return cls.from_checkpoint(os.path.join(run_dir, "ckpts"),
                                   os.path.join(run_dir, "vocab.json"),
                                   os.path.join(run_dir, "emb.npz"), cfg, vgg_spec=vgg_spec, **kw)

    # -- inference ----------------------------------------------------------

    def _to_device(self, raw: Mapping) -> dict:
        """A batch on the model's device: numpy arrays through the pinned
        side-stream upload (ordered before later work on the current
        stream), tensors already there as they are."""
        host = {k: v for k, v in raw.items() if not isinstance(v, torch.Tensor)}
        out = self._upload(host)
        if isinstance(out, InFlight):
            out = out.claim()
        return {**out, **{k: v for k, v in raw.items() if isinstance(v, torch.Tensor)}}

    def warmup(self, frame_hw: tuple[int, int] = (240, 320), batch_size: int | None = None,
               include_long: bool = False) -> None:
        """Run the serving program once on a zero batch at every shape the
        first requests will take, so they do not pay what a first call
        costs on the card: the build or load of the kernel library, each
        shape's kernel plan and occupancy check, cuDNN's choice of conv
        algorithm and the allocator's first blocks.

        ``frame_hw`` is the corpus's decoded frame size (a shape of the raw
        batch); ``batch_size`` the batch to warm (a ``DynamicBatcher``'s
        ``max_batch_size``), by default ``serve_batch_size`` or 1. Under
        ``serve_buckets`` it runs the full shape and every diagonal rung
        level (``bucket_ladder_levels``); other rung tuples warm on their
        first request. ``include_long`` also runs ``summarize_long``'s
        programs: the B=1 decodes of a short transcript and the featurized
        window decode. Top-k warms under a generator of its own, so a warmed
        summarizer samples exactly as a cold one."""
        d = self.cfg.data
        b = batch_size or self.serve_batch_size or 1
        h, w = frame_hw
        gen = torch.Generator(self.device).manual_seed(0) if self.mode == "topk" else None

        def zero_raw(rungs: Mapping[str, int] | None = None, nb: int = b) -> dict:
            r = rungs or {}
            t_s = r.get("sentences", d.max_sentences)
            t_w = r.get("words", d.max_words)
            t_i = r.get("keyframes", d.max_keyframes)
            t_a = r.get("audio_frames", d.max_audio_frames)
            return {
                "text_ids": np.zeros((nb, t_s, t_w), np.int32),
                "word_mask": np.ones((nb, t_s, t_w), np.float32),
                "sent_mask": np.ones((nb, t_s), np.float32),
                "frames": np.zeros((nb, t_i, h, w, 3), np.uint8),
                "img_mask": np.ones((nb, t_i), np.float32),
                "waveform": np.zeros((nb, t_a * d.hop_length + d.win_length), np.float32),
                "aud_mask": np.ones((nb, t_a), np.float32),
            }

        def run(raw: dict, **kw) -> None:
            self._decode_batch(self._to_device(raw), generator=gen, **kw)

        raw = zero_raw()
        run(raw)
        for rungs in self.bucket_levels:
            run(zero_raw(rungs))
        if not include_long:
            return
        if b != 1:
            # a short transcript decodes its raw media at B=1 (and at B=1
            # rung shapes under serve_buckets)
            run(zero_raw(nb=1))
            for rungs in self.bucket_levels:
                run(zero_raw(rungs, nb=1))
        feat = self._featurize({k: raw[k][:1] for k in ("frames", "img_mask", "waveform", "aud_mask")})
        run({**{k: raw[k] for k in ("text_ids", "word_mask", "sent_mask")},
             **{k: v.repeat(b, *([1] * (v.dim() - 1))) for k, v in feat.items()}},
            with_scores=True)

    def _raw_row(self, video_dir: str) -> tuple[dict, list[str]]:
        """Host-decode ONE video's assets into an (unstacked) numpy row: pure
        host work, safe from many request threads at once."""
        return host_raw_row(video_dir, self.word2idx, self.cfg)

    def _stack_rows(self, rows: Sequence[dict]) -> dict:
        """Stack per-video rows (numpy arrays, or tensors already on the
        card) into one batch on the model's device. Under ``serve_buckets``
        each row is trimmed to the rungs covering the batch's true lengths
        first, so only the trimmed batch is stacked and uploaded."""
        if self._ladders is not None:
            needs: dict[str, int] = {}
            for r in rows:
                for k, v in batch_true_lengths(r).items():
                    needs[k] = max(needs.get(k, 0), v)
            rungs = covering_rungs(needs, self._ladders)
            rows = [trim_raw_to_rungs(r, self.cfg, rungs, batched=False) for r in rows]
        raw = {k: (torch.stack([r[k] for r in rows]) if isinstance(rows[0][k], torch.Tensor)
                   else np.stack([r[k] for r in rows])) for k in rows[0]}
        if self._ladders is not None:
            record_bucket_stat(self.bucket_stats, self._stats_lock, raw)
        return self._to_device(raw)

    def _raw_batch(self, video_dirs: Sequence[str], pad_to: int | None = None
                   ) -> tuple[dict, list[list[str]]]:
        """Decode the videos and stack them into a device batch of
        ``pad_to`` rows (default: one a video), the last row repeated: each
        video is decoded once."""
        rows, sentences = [], []
        for vd in video_dirs:
            row, sents = self._raw_row(vd)
            rows.append(row)
            sentences.append(sents)
        rows += [rows[-1]] * ((pad_to or len(rows)) - len(rows))
        return self._stack_rows(rows), sentences

    def _featurize(self, media: Mapping) -> dict:
        """The frontend alone on a media batch (``summarize_long``); under
        ``sp_audio`` the waveform stays raw, for the SP tower of each window."""
        with self._lock:
            media = self._to_device(media)
            if self.feed is not None:
                self.feed.send("featurize", media)
            return self._featurize_local(media)

    def _featurize_local(self, media: Mapping[str, torch.Tensor]) -> dict:
        with torch.inference_mode():
            return apply_frontend(self.frontend, media, self.cfg, self.vgg_spec,
                                  sp_audio=self._audio_g_fn is not None)

    def _decode_batch_device(self, raw: Mapping[str, torch.Tensor],
                             generator: torch.Generator | None = None):
        """Dispatch the decode of a device batch → ``(log_p, picks)`` on the
        device, without waiting for them. Top-k draws from ``generator``, by
        default the summarizer's own. Every device call of the serving API
        passes through here or ``_featurize``, where a daemon's rank 0 sends
        it to the other ranks (``feed``)."""
        with self._lock:
            if self.feed is not None:
                self.feed.send("decode", raw, generator)
            return self._decode_local(raw, generator)

    def _decode_local(self, raw: Mapping[str, torch.Tensor], generator=None):
        gen = generator if generator is not None else self._generator
        return self._decode(self.model, self.frontend, raw, gen)

    def follow(self, kind: str, arrays: Mapping[str, torch.Tensor], gen_state=None) -> None:
        """A rank past 0 of a serving daemon: the device call rank 0 sent,
        with a generator in the caller's state where it passed one."""
        if kind == "featurize":
            self._featurize_local(arrays)
            return
        gen = None
        if gen_state is not None:
            gen = torch.Generator(self.device)
            gen.set_state(gen_state)
        self._decode_local(arrays, gen)

    def parallelism(self) -> dict | None:
        """The mesh layout (``/healthz``), or None without a mesh."""
        if self._mesh is None:
            return None
        return {"mesh_axes": dict(self._mesh.shape), "dp_shards": int(self._dp_shards),
                "sp_audio": self._audio_g_fn is not None, "tp_vgg": bool(self.cfg.mesh.tp_vgg)}

    def _decode_batch(self, raw, with_scores: bool = False,
                      generator: torch.Generator | None = None):
        """Picks ``[B, K]``, and with ``with_scores`` each pick's merge score."""
        log_p, picks = self._decode_batch_device(raw, generator=generator)
        picks = picks.cpu().numpy()
        if not with_scores:
            return picks
        return picks, picks_scores(log_p.cpu().numpy(), picks)

    def summarize_batch(self, video_dirs: Sequence[str]) -> list[str]:
        if not video_dirs:
            return []
        sb = self.serve_batch_size
        if sb is None:
            raw, sentences = self._raw_batch(video_dirs)
            picks = self._decode_batch(raw)
            return [summary_from_picks(picks[i], sentences[i]) for i in range(len(video_dirs))]
        # Static-shape serving: chunks of sb (the tail padded by repeating the
        # last video's row, sliced off after). Host decode of chunk i+1
        # overlaps the device work of chunk i.
        chunks = [list(video_dirs[start:start + sb]) for start in range(0, len(video_dirs), sb)]
        out: list[str] = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = ex.submit(self._raw_batch, chunks[0], sb)
            for i, chunk in enumerate(chunks):
                raw, sentences = pending.result()
                if i + 1 < len(chunks):
                    pending = ex.submit(self._raw_batch, chunks[i + 1], sb)
                picks = self._decode_batch(raw)
                out.extend(summary_from_picks(picks[j], sentences[j]) for j in range(len(chunk)))
        return out

    def summarize(self, video_dir: str) -> str:
        return self.summarize_batch([video_dir])[0]

    def summarize_long(self, video_dir: str, stride: int | None = None) -> str:
        """Summarize a video whose transcript exceeds the ``max_sentences``
        bucket (``summarize`` would cut it): overlapping windows of
        ``max_sentences`` sentences (``stride`` defaults to half a window)
        are decoded against the video's whole keyframe and audio context,
        featurized once at B=1 (trimmed to its rungs under
        ``serve_buckets``), and their picks merged by score. Window batches
        are padded and chunked to ``serve_batch_size`` when set."""
        d, m = self.cfg.data, self.cfg.model
        assets = load_video_assets(
            video_dir, d.max_keyframes, num_audio_samples(self.cfg),
            keyframe_policy=d.keyframe_policy, sample_rate=d.sample_rate,
        )
        sentences = sent_tokenize(assets["transcript"])
        n_aud = audio_frames_valid(assets["valid_samples"], d.hop_length, d.max_audio_frames)
        media = {
            "frames": assets["frames"],
            "img_mask": assets["img_mask"],
            "waveform": assets["waveform"],
            "aud_mask": (np.arange(d.max_audio_frames) < n_aud).astype(np.float32),
        }

        def window_row(sents, media_row):
            enc = encode_sentences(sents, self.word2idx, d.max_sentences, d.max_words)
            return {"text_ids": enc["text_ids"], "word_mask": enc["word_mask"],
                    "sent_mask": enc["sent_mask"], **media_row}

        if len(sentences) <= d.max_sentences:
            # one window over the assets already loaded
            picks = self._decode_batch(self._stack_rows([window_row(sentences, media)]))
            return summary_from_picks(picks[0], sentences)

        # Featurize the media once, trimmed first (the padded VGG and MFCC
        # work is here): every window shares the video's context, which
        # stays on the card as features; the masks stay on the host.
        media_b = {k: v[None] for k, v in media.items()}
        if self._ladders is not None:
            media_b = trim_raw_batch(media_b, self.cfg, self._ladders)
        feat = self._featurize(media_b)
        media = {k: (media_b[k][0] if k.endswith("_mask") else v[0]) for k, v in feat.items()}
        stride = stride or max(d.max_sentences // 2, 1)
        starts = transcript_windows(len(sentences), d.max_sentences, stride)
        rows = [window_row(sentences[st:st + d.max_sentences], media) for st in starts]
        sb = self.serve_batch_size or len(rows)
        picks_l, scores_l = [], []
        for i in range(0, len(rows), sb):
            chunk = rows[i:i + sb]
            n_real = len(chunk)
            p, sc = self._decode_batch(self._stack_rows(chunk + [chunk[-1]] * (sb - n_real)),
                                       with_scores=True)
            picks_l.append(p[:n_real])
            scores_l.append(sc[:n_real])
        window_lens = [min(d.max_sentences, len(sentences) - st) for st in starts]
        chosen = merge_window_picks(np.concatenate(picks_l), np.concatenate(scores_l), starts,
                                    window_lens, m.max_decode_steps)
        return " ".join(sentences[g] for g in chosen)


class DynamicBatcher:
    """Dynamic micro-batching of concurrent single-video requests.

    Many request threads call ``submit``; their videos are coalesced into
    one device batch, which amortizes the model far better than B=1 calls.

    Split of work:
      * ``submit()`` (request threads): host asset decode and tokenization
        (``Summarizer._raw_row``), in parallel across requests and beside
        the device;
      * one batcher thread: takes the first queued row, gathers more for up
        to ``max_wait_ms`` (or to ``max_batch_size``), pads the batch to
        ``max_batch_size`` by repeating its last row, uploads it and
        dispatches the decode without waiting for it; it is the only thread
        of the batcher that dispatches to the card;
      * one completion thread (``pipeline_depth >= 1``): waits for each
        dispatched batch's picks (``HostFetch``) and resolves its futures,
        while the batcher thread collates, uploads and dispatches the next
        batch; it only fetches. ``pipeline_depth=0`` fetches on the batcher
        thread instead.

    Every device batch has ``max_batch_size`` rows, one shape for the
    kernels' plans, as ``Summarizer.serve_batch_size`` pins. On a bucketed
    summarizer (``group_buckets``) a coalesced set is split by each
    request's covering rung level, one device batch a level, so one long
    video does not drag short ones to the caps.

    Errors: a host-decode error raises in the submitting thread and fails
    that request only. A batch error (stacking, dispatch) fails every
    request of the batch, and so does a device fault, which surfaces where
    the completion thread waits for the picks; neither thread dies. A
    sticky CUDA error (an illegal address) leaves the process's CUDA
    context unusable: every later batch fails as well, and only a new
    process serves again. With ``max_queue``, ``submit`` sheds load once
    that many requests are pending (``ServerOverloadedError``, before any
    host decode).

    Greedy and beam answers do not depend on how requests were coalesced;
    top-k draws its noise per device batch, so its samples do.
    """

    def __init__(
        self,
        summarizer: Summarizer,
        max_batch_size: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int | None = None,
        group_buckets: bool = True,
        pipeline_depth: int = 1,
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, got {max_queue}")
        if max_batch_size % summarizer._dp_shards != 0:
            raise ValueError(f"max_batch_size must be a multiple of the summarizer's "
                             f"{summarizer._dp_shards} data-parallel shards, got {max_batch_size}")
        fixed = getattr(summarizer, "fixed_batch_size", None)
        if fixed is not None and max_batch_size != fixed:
            # a frozen artifact holds one batch shape: fail at setup
            raise ValueError(f"this summarizer serves a fixed batch of {fixed}; max_batch_size "
                             f"must equal it, got {max_batch_size}")
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {pipeline_depth}")
        self.summarizer = summarizer
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = max_queue
        self.group_buckets = bool(group_buckets)
        self.pipeline_depth = int(pipeline_depth)
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                      "rejected": 0, "bucket_splits": 0}
        # 'rejected' is bumped by submitter threads; the rest by the batcher thread
        self._reject_lock = threading.Lock()
        self._close_lock = threading.Lock()  # orders submit's put against close
        self._queue: _queue_mod.Queue = _queue_mod.Queue()
        self._closed = False
        self._completer = None
        if self.pipeline_depth:
            # bounded: a full queue blocks the batcher thread's put, so at
            # most `depth` dispatched batches wait to be fetched
            self._inflight: _queue_mod.Queue = _queue_mod.Queue(maxsize=self.pipeline_depth)
            self._completer = threading.Thread(target=self._complete_loop,
                                               name="mmbidaf-batcher-fetch", daemon=True)
            self._completer.start()
        self._thread = threading.Thread(target=self._loop, name="mmbidaf-batcher", daemon=True)
        self._thread.start()

    # -- request side -------------------------------------------------------

    def submit(self, video_dir: str) -> str:
        """Summarize one video; blocks until its batch completes. Thread-safe."""
        if self._closed:
            raise RuntimeError("DynamicBatcher is closed")
        # shed load before the host decode, so rejecting stays cheap; qsize()
        # is approximate under concurrency, which a load shedder tolerates
        if self.max_queue is not None and self._queue.qsize() >= self.max_queue:
            with self._reject_lock:
                self.stats["rejected"] += 1
            raise ServerOverloadedError(f"pending-request queue at max_queue={self.max_queue}; "
                                        "retry later")
        row, sentences = self.summarizer._raw_row(video_dir)  # host work, caller's thread
        fut: Future = Future()
        # close() may have drained and stopped the loop during the decode:
        # a put after that would block this caller on a queue nobody reads
        with self._close_lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._queue.put((row, sentences, fut))
        return fut.result()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the batcher thread; in-flight batches finish, then queued
        requests that never made it into a batch fail with RuntimeError."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(None)
        self._thread.join(timeout)
        self._drain_failed()  # whatever raced into the queue before _closed flipped

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- batcher thread -----------------------------------------------------

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._drain_failed()
                self._shutdown_completer()
                return
            items = [item]
            deadline = time.monotonic() + self.max_wait_s
            stop = False
            while len(items) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except _queue_mod.Empty:
                    break
                if nxt is None:
                    stop = True  # run what we have, then exit
                    break
                items.append(nxt)
            self._run_batch(items)
            if stop:
                self._drain_failed()
                self._shutdown_completer()
                return

    def _shutdown_completer(self) -> None:
        """The completion thread resolves the batches in flight, then exits
        (on the batcher thread, so close()'s join covers the drain)."""
        if self._completer is not None:
            self._inflight.put(None)
            self._completer.join()

    def _drain_failed(self) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except _queue_mod.Empty:
                return
            if item is not None:
                item[2].set_exception(RuntimeError("DynamicBatcher closed"))

    def _run_batch(self, items: list) -> None:
        # A grouping failure fails these futures and never escapes: an
        # exception out of here would kill the batcher thread and hang every
        # pending and later submit().
        try:
            groups = None
            levels = self.summarizer.bucket_levels if self.group_buckets else []
            if levels and len(items) > 1:
                groups = {}
                for it in items:
                    groups.setdefault(covering_level(levels, batch_true_lengths(it[0])), []).append(it)
        except Exception as e:
            for _, _, fut in items:
                fut.set_exception(e)
            return
        if groups and len(groups) > 1:
            self.stats["bucket_splits"] += 1
            # smallest level first: short requests resolve soonest
            for _, group in sorted(groups.items(), key=lambda kv: kv[0] if kv[0] >= 0 else 1 << 30):
                self._run_group(group)
            return
        self._run_group(items)

    def _run_group(self, items: list) -> None:
        n_real = len(items)
        # everything batch-scoped stays inside the try: a stacking error
        # (videos decoded at different frame sizes) fails these futures
        # instead of killing the batcher thread
        try:
            rows = [row for row, _, _ in items]
            rows = rows + [rows[-1]] * (self.max_batch_size - n_real)
            raw = self.summarizer._stack_rows(rows)
            picks = self.summarizer._decode_batch_device(raw)[1]
            pending = HostFetch(picks) if isinstance(picks, torch.Tensor) else picks
        except Exception as e:
            for _, _, fut in items:
                fut.set_exception(e)
            return
        # stats count dispatched batches (single writer: the batcher thread)
        self.stats["requests"] += n_real
        self.stats["batches"] += 1
        self.stats["padded_rows"] += self.max_batch_size - n_real
        if self._completer is not None:
            self._inflight.put((pending, items))
        else:
            self._finish(pending, items)

    def _finish(self, pending, items: list) -> None:
        """Wait for one dispatched batch's picks and resolve its futures.
        Never raises: a device fault fails the batch's futures."""
        try:
            picks = pending.numpy()
            summaries = [summary_from_picks(picks[i], items[i][1]) for i in range(len(items))]
        except Exception as e:
            for _, _, fut in items:
                fut.set_exception(e)
            return
        for i, (_, _, fut) in enumerate(items):
            fut.set_result(summaries[i])

    def _complete_loop(self) -> None:
        while True:
            job = self._inflight.get()
            if job is None:
                return
            self._finish(*job)
