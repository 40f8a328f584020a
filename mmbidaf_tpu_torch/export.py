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

Scope: greedy and beam, on one device or on a mesh (``parallel/``: one
process a device under ``torchrun``) — data-parallel, the tensor-parallel
VGG classifier (``MeshConfig.tp_vgg``), or both. Top-k (it carries a
generator) and ``sp_audio`` are refused as in the JAX package.

A mesh artifact freezes the per-rank program, one file every rank loads,
and keeps every collective OUT of the graph (``torch.export`` records a
collective's group by a name that is only the order in which the process
made its groups, so a loader that made its groups in another order would
reduce over the wrong ranks without a sign). Its manifest (format 2)
records the mesh (axis names, shape, the batch axes) and, per weight leaf,
``null`` or the dim and axis it is split on; ``weights.pt`` holds every
leaf once, whole, and each rank cuts its own shard at load. The loader
rebuilds the mesh over its own process group (``parallel.mesh``) and runs
the collectives in Python around the programs: under data parallelism each
rank runs its rows of the batch, which every rank is given whole, and the
log-probs and picks are all-gathered over the batch axes, as the live
``Summarizer(data_parallel=True)`` does; a split classifier is frozen as
two programs, split at its one all-reduce — ``decode.head.pt2`` (frames →
this rank's fc2 partial product) and ``decode.pt2`` (the summed product,
the other inputs → picks) — and the loader sums the partial products over
``model`` between them. A TP artifact whose batch the data axes do not
divide replicates the batch (``batch_axes`` empty). The loader refuses a
process group of another size than the mesh's.
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
_FORMAT_VERSION = 1  # a single-device program
_FORMAT_VERSION_MESH = 2  # a mesh's per-rank program(s): "mesh", "weight_shards", "head_file"
_SUPPORTED_VERSIONS = (1, 2)

# Raw-input call order is pinned by the manifest, not by dict iteration.
_RAW_KEYS = (
    "text_ids", "word_mask", "sent_mask",
    "frames", "img_mask", "waveform", "aud_mask",
)
_MASKS = ("word_mask", "sent_mask", "img_mask", "aud_mask")
# a split classifier's programs: the head takes the frames, the tail the
# other raw inputs and the partial products summed over ``model``
_SUM = "fc2_sum"
_PART_KEYS = {"whole": _RAW_KEYS, "head": ("frames",),
              "tail": tuple(k for k in _RAW_KEYS if k != "frames") + (_SUM,)}
_TP_SPLIT = {"frontend.vgg.fc1_w": 1, "frontend.vgg.fc1_b": 0, "frontend.vgg.fc2_w": 0}


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
    the serving program on a raw batch (``part="whole"``), or one of the two
    halves of a split classifier's program: ``"head"`` (frames → this rank's
    fc2 partial product, ``[B·T_i, fc]``) and ``"tail"`` (the summed product
    in place of the frames → picks)."""

    def __init__(self, summ):
        super().__init__()
        self.model = summ.model
        self.frontend = summ.frontend
        self.cfg, self.vgg_spec, self.mode, self.width = summ.cfg, summ.vgg_spec, summ.mode, summ.topk

    def forward(self, raw: dict, part: str = "whole"):
        from mmbidaf_tpu_torch.data.frontend import (apply_frontend, frames_through_vgg,
                                                     masked_image_features)
        from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode
        from mmbidaf_tpu_torch.ops.vgg import vgg_fc2_finish, vgg_fc2_partial

        if part == "head":
            return frames_through_vgg(self.frontend, raw["frames"], self.cfg, self.vgg_spec,
                                      features=vgg_fc2_partial)
        if part == "tail":
            raw = dict(raw)
            feats = vgg_fc2_finish(self.frontend.vgg, raw.pop(_SUM))
            raw["images"] = masked_image_features(feats, raw["img_mask"])
        batch = apply_frontend(self.frontend, raw, self.cfg, self.vgg_spec)
        return mmbidaf_decode(self.model, batch, self.cfg, mode=self.mode, topk=self.width)


class _FlatProgram(torch.nn.Module):
    """``forward(*weight_leaves, *inputs)``: the weights go in as arguments
    (``functional_call``), as the JAX package's ``flat_fn`` takes them, so
    no program holds a copy of them; the inputs are ``_PART_KEYS[part]``.
    The served module sits in a list, out of ``torch.export``'s reach as
    parameters."""

    def __init__(self, served: _Served, names: Sequence[str], part: str = "whole"):
        super().__init__()
        self._served = [served]
        self.names = list(names)
        self.part = part

    def forward(self, *leaves):
        n = len(self.names)
        weights = dict(zip(self.names, leaves[:n]))
        raw = dict(zip(_PART_KEYS[self.part], leaves[n:]))
        return torch.func.functional_call(self._served[0], weights, (raw, self.part), strict=True)


def _example_raw(specs: Mapping[str, RawSpec], device) -> list[torch.Tensor]:
    """A batch at ``specs``' shapes on ``device``: zeros, masks all ones."""
    return [torch.from_numpy((np.ones if k in _MASKS else np.zeros)(specs[k].shape, specs[k].dtype))
            .to(device) for k in _RAW_KEYS]


def _mesh_layout(summ, batch_size: int) -> dict | None:
    """The manifest's ``mesh`` for a summarizer on a mesh (None on one
    device), with the JAX package's checks."""
    mesh = summ._mesh
    if mesh is None:
        return None
    from mmbidaf_tpu_torch.parallel.mesh import _data_axes, data_shard_count

    if summ._dp and batch_size % summ._dp_shards != 0:
        raise ValueError(f"data_parallel export shards the batch over {summ._dp_shards} devices: "
                         f"batch_size must be a multiple (got {batch_size})")
    n = data_shard_count(mesh)
    # a TP-only artifact may pin a batch the data axes do not divide: every
    # rank then takes the whole batch
    return {"axis_names": list(mesh.axis_names),
            "shape": [mesh.shape[a] for a in mesh.axis_names],
            "batch_axes": list(_data_axes(mesh)) if batch_size % n == 0 else []}


def _rank_rows(layout: Mapping | None, batch_size: int) -> int:
    """Rows of the batch one rank's program takes."""
    if not layout or not layout["batch_axes"]:
        return batch_size
    sizes = dict(zip(layout["axis_names"], layout["shape"]))
    return batch_size // int(np.prod([sizes[a] for a in layout["batch_axes"]]))


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
    covering its true lengths.

    A summarizer on a mesh exports its per-rank program(s) (the module's
    docstring): every rank of the group calls this (the split classifier's
    leaves are gathered whole), rank 0 traces and writes the files, and
    every rank returns the manifest."""
    from mmbidaf_tpu_torch.data.frontend import vgg_frame_chunk
    from mmbidaf_tpu_torch.models.mmbidaf import torch_dtype
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.train.checkpoint import save_config

    if not isinstance(summ, Summarizer):
        raise TypeError(f"expected a Summarizer, got {type(summ).__name__}")
    if summ.mode not in ("greedy", "beam"):
        raise ValueError(
            f"only the deterministic paths export (mode={summ.mode!r}): greedy and beam are pure "
            "functions of weights + raw batch; top-k carries an rng stream — serve it "
            "interactively via Summarizer")
    cfg = summ.cfg
    if cfg.mesh.sp_audio:
        raise ValueError("sp_audio serving programs route through shard_map chains and are not "
                         "exportable; export a non-SP Summarizer")
    layout = _mesh_layout(summ, batch_size)
    rows = _rank_rows(layout, batch_size)
    split = getattr(getattr(summ.frontend, "vgg", None), "tp", None) is not None
    dev = summ.device
    served = _Served(summ)
    named = dict(served.named_parameters())
    named.update(served.named_buffers())
    names = list(named)
    weights = [named[n].detach() for n in names]
    shards = [_TP_SPLIT.get(n) if split else None for n in names]
    whole = _whole_leaves(summ, weights, shards)

    def export_part(part: str, inputs: list, fname: str) -> None:
        with torch.no_grad():
            ep = torch.export.export(_FlatProgram(served, names, part), tuple(weights + inputs),
                                     strict=False)
        ep.example_inputs = None  # they hold the weights: weights.pt holds them once
        torch.export.save(ep, os.path.join(out_dir, fname))

    def export_level(fname: str, rungs=None) -> dict:
        example = dict(zip(_RAW_KEYS, _example_raw(_raw_specs(cfg, rows, frame_hw, rungs), dev)))
        n_frames = rows * (rungs or {}).get("keyframes", cfg.data.max_keyframes)
        head = None
        if split:
            head = fname.replace(".pt2", ".head.pt2")
            export_part("head", [example["frames"]], head)
            summed = torch.zeros(n_frames, summ.frontend.vgg.fc2_w.shape[1], device=dev,
                                 dtype=torch_dtype(cfg.model.compute_dtype))
            export_part("tail", [example[k] for k in _PART_KEYS["tail"][:-1]] + [summed], fname)
        else:
            export_part("whole", [example[k] for k in _RAW_KEYS], fname)
        entry = {"file": fname,
                 "raw_inputs": _spec_entries(_raw_specs(cfg, batch_size, frame_hw, rungs)),
                 "vgg_frame_chunk": vgg_frame_chunk(cfg, n_frames, summ.vgg_spec, dev)
                 if cfg.model.use_images else None}
        if layout is not None:
            entry["head_file"] = head
        return entry

    def write() -> dict:
        os.makedirs(out_dir, exist_ok=True)
        main = export_level(_PROGRAM)
        bucket_manifest = None
        if buckets:
            bucket_manifest = [{**export_level(f"decode.b{i}.pt2", rungs), "rungs": rungs}
                               for i, rungs in enumerate(_bucket_levels(cfg, buckets))]
        torch.save(dict(zip(names, whole)), os.path.join(out_dir, _WEIGHTS))
        save_config(out_dir, cfg)
        with open(os.path.join(out_dir, _VOCAB), "w") as f:
            json.dump(summ.word2idx, f)
        files = [_WEIGHTS, _PROGRAM, _CONFIG, _VOCAB]
        files += [e["head_file"] for e in [main] if e.get("head_file")]
        for e in bucket_manifest or []:
            files += [e["file"]] + ([e["head_file"]] if e.get("head_file") else [])
        manifest = {
            "format_version": _FORMAT_VERSION if layout is None else _FORMAT_VERSION_MESH,
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
            "weight_dtypes": [str(w.dtype).removeprefix("torch.") for w in whole],
            "raw_inputs": main["raw_inputs"],
            "vgg_frame_chunk": main["vgg_frame_chunk"],
            # greedy: log_p per step [B, K, T_s]; beam: the best beam's total
            # sequence log-prob [B], its width fixed at export
            "decode_mode": summ.mode,
            "beam_width": summ.topk if summ.mode == "beam" else None,
            "outputs": ["log_p", "picks"],
            "mesh": layout,  # null: a single-device program
            "bucket_programs": bucket_manifest,
        }
        if layout is not None:
            manifest["head_file"] = main["head_file"]
            # per leaf: null (whole on every rank) or the dim it is split on
            # over the model axis, in rank order
            manifest["weight_shards"] = [None if d is None else {"dim": d, "axis": "model"}
                                         for d in shards]
        with open(os.path.join(out_dir, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        return manifest

    if layout is None or summ._mesh.device_mesh is None:
        return write()
    return _on_rank0(write)


def _whole_leaves(summ, weights: list, shards: list) -> list:
    """The weights whole on the host: a split leaf's shards gathered over
    ``model`` (every rank takes part)."""
    from mmbidaf_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather

    group = summ._mesh.group(MODEL_AXIS) if summ._mesh is not None else None
    return [(w if d is None else all_gather(w, group, dim=d)).cpu()
            for w, d in zip(weights, shards)]


def _on_rank0(fn):
    """``fn()`` on rank 0 of the default group; every rank returns its result
    or raises its error."""
    import torch.distributed as dist

    out: list = [None]
    if dist.get_rank() == 0:
        try:
            out[0] = ("ok", fn())
        except Exception as e:  # the other ranks must not wait forever
            out[0] = ("error", f"{type(e).__name__}: {e}")
            dist.broadcast_object_list(out, src=0)
            raise
    dist.broadcast_object_list(out, src=0)
    status, value = out[0]
    if status != "ok":
        raise RuntimeError(f"rank 0 failed to export the artifact: {value}")
    return value


def layout_flag_conflict(manifest: Mapping, data_parallel=None, tp_vgg=None, num_model=None,
                         sp_audio=None, num_seq=None) -> str | None:
    """Why a mesh flag given to a CLI with ``--artifact`` disagrees with the
    layout the artifact froze, or None when every given flag (not None)
    matches it."""
    layout = manifest.get("mesh") or {"axis_names": [], "shape": [], "batch_axes": []}
    sizes = dict(zip(layout["axis_names"], layout["shape"]))
    split = any(manifest.get("weight_shards") or [])
    frozen = {"--data_parallel": bool(layout["batch_axes"]), "--tp_vgg": int(split),
              "--num_model": sizes.get("model", 1), "--sp_audio": 0, "--num_seq": 1}
    given = {"--data_parallel": data_parallel, "--tp_vgg": tp_vgg, "--num_model": num_model,
             "--sp_audio": sp_audio, "--num_seq": num_seq}
    for flag, value in given.items():
        if value is not None and value != frozen[flag]:
            return (f"{flag} {value} does not match the artifact's layout (mesh {sizes or 'none'}, "
                    f"batch axes {layout['batch_axes']}, classifier split: {split}): the layout "
                    "is fixed at export time — re-export it")
    return None


class ExportedDecoder:
    """The device half of an artifact: raw batch in, ``(log_p, picks)`` out.

    Imports torch, numpy and the serving kernels' custom ops, and nothing of
    the model's code, so a serving host runs it without ``models``,
    ``serving`` or ``data.frontend`` (``tests/test_torch_export.py`` proves
    it in a fresh process; a mesh artifact adds ``parallel.mesh``). Every
    file's sha256 is checked before anything is loaded. Each program runs
    under ``torch.inference_mode`` and, for an f32 artifact, with cuDNN's
    convolutions pinned to full f32. Dispatches hold one lock, so request
    threads may share a decoder. Host-side preprocessing lives in
    ``ExportedSummarizer``.

    A mesh artifact loads on every rank of a process group of the mesh's
    size (one rank without a group when the mesh holds one), each rank its
    own shards; every rank is then given the same whole batch. Under a
    serving daemon, ``feed`` (``serving.MeshFeed``) is set on rank 0, which
    then sends each batch to the other ranks before running it."""

    feed = None

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
        self.layout = m.get("mesh")
        shards = m.get("weight_shards") or [None] * m["n_weight_leaves"]
        if len(shards) != m["n_weight_leaves"]:
            # zip() below would leave the tail leaves whole
            raise ValueError(f"manifest weight_shards has {len(shards)} entries for "
                             f"{m['n_weight_leaves']} weight leaves — corrupted or mixed "
                             "artifact")
        self._mesh = self._make_mesh() if self.layout is not None else None
        for fname, digest in m["sha256"].items():
            if _file_sha256(os.path.join(artifact_dir, fname)) != digest:
                raise ValueError(f"{fname} does not match the manifest's sha256 — the artifact is "
                                 "corrupted or its files were mixed from different exports; "
                                 "re-export or re-copy it")
        split = any(shards)
        tensors = torch.load(os.path.join(artifact_dir, _WEIGHTS), weights_only=True,
                             map_location="cpu" if split else self.device)
        names = m["weight_names"]
        if len(names) != m["n_weight_leaves"] or set(names) != set(tensors):
            raise ValueError("the manifest's weight names do not match weights.pt — corrupted or "
                             "mixed artifact")
        self._weights = [self._shard(tensors[n], spec) for n, spec in zip(names, shards)]
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
        self._programs = [{"file": _PROGRAM, "raw_inputs": m["raw_inputs"], "rungs": None,
                           "head_file": m.get("head_file")}]
        self._programs += [dict(e) for e in buckets]
        for prog in self._programs:
            for key, fname in (("run", prog["file"]), ("head", prog.get("head_file"))):
                prog[key] = (torch.export.load(os.path.join(artifact_dir, fname)).module()
                             if fname else None)
        self.bucket_levels = [e["rungs"] for e in buckets]
        self._lock = threading.Lock()

    def _make_mesh(self):
        """The exporting mesh's axes over this process group, which must have
        the mesh's size."""
        from mmbidaf_tpu_torch.parallel.mesh import mesh_from_axes, world

        names, shape = self.layout["axis_names"], self.layout["shape"]
        n = int(np.prod(shape))
        if world()[1] != n:
            raise ValueError(f"the artifact was exported for a {dict(zip(names, shape))} mesh of "
                             f"{n} processes; this process group has {world()[1]} (start "
                             f"{n} processes, e.g. torchrun --nproc_per_node {n})")
        return mesh_from_axes(names, shape, self.device)

    def _shard(self, w: torch.Tensor, spec: Mapping | None) -> torch.Tensor:
        """This rank's shard of a whole leaf, on the device."""
        if spec is not None:
            n, k = self._mesh.shape[spec["axis"]], self._mesh.coords[spec["axis"]]
            size = w.shape[spec["dim"]] // n
            w = w.narrow(spec["dim"], k * size, size).contiguous()
        return w.to(self.device)

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
        args = {s["name"]: self._arg(raw[s["name"]], s) for s in prog["raw_inputs"]}
        with self._lock:
            if self.feed is not None:
                self.feed.send("decode", args)
            return self._call(prog, args)

    def _call(self, prog: dict, args: Mapping[str, torch.Tensor]):
        """One program on a batch on the device; on a mesh, this rank's
        share of it and the collectives around the programs."""
        dtype = torch.float32 if self.compute_dtype == "float32" else None
        with torch.inference_mode(), full_f32_convs(dtype):
            if self._mesh is None:
                return prog["run"](*self._weights, *(args[k] for k in _RAW_KEYS))
            from mmbidaf_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather, all_reduce

            batch_axes = self.layout["batch_axes"]
            if batch_axes:
                per = self.batch_size // self._mesh.axis_size(batch_axes)
                start = self._mesh.axis_index(batch_axes) * per
                args = {k: v[start:start + per] for k, v in args.items()}
            if prog["head"] is not None:
                part = prog["head"](*self._weights, args["frames"])
                args = {**args, _SUM: all_reduce(part, self._mesh.group(MODEL_AXIS))}
                out = prog["run"](*self._weights, *(args[k] for k in _PART_KEYS["tail"]))
            else:
                out = prog["run"](*self._weights, *(args[k] for k in _RAW_KEYS))
            if batch_axes:
                group = self._mesh.group(batch_axes)
                out = tuple(all_gather(t, group) for t in out)
            return out

    def follow(self, kind: str, arrays: Mapping[str, torch.Tensor], gen_state=None) -> None:
        """A rank past 0 of a serving daemon: the device call rank 0 sent."""
        self._call(self._select_program(arrays), arrays)

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

    def __init__(self, artifact_dir: str, device="cuda"):
        from mmbidaf_tpu_torch.config import config_from_json

        self.decoder = ExportedDecoder(artifact_dir, device)
        # the batcher's check: a batch the ranks split evenly
        self._dp_shards = (self.decoder._mesh.axis_size(self.decoder.layout["batch_axes"])
                           if self.decoder.layout else 1)
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
    def feed(self):
        """``serving.MeshFeed`` of a daemon's rank 0 (None: no other rank)."""
        return self.decoder.feed

    @feed.setter
    def feed(self, feed) -> None:
        self.decoder.feed = feed

    def follow(self, kind: str, arrays: Mapping[str, torch.Tensor], gen_state=None) -> None:
        self.decoder.follow(kind, arrays, gen_state)

    def parallelism(self) -> dict | None:
        """The frozen mesh (``/healthz``), or None for a single-device program."""
        layout = self.decoder.layout
        if layout is None:
            return None
        return {"mesh_axes": dict(zip(layout["axis_names"], layout["shape"])),
                "artifact_format": self.decoder.manifest["format_version"]}

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
