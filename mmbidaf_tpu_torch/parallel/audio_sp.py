"""Sequence-parallel audio frontend — the port of ``mmbidaf_tpu.parallel.audio_sp``.

The frame axis of the MFCC / log-mel stage shards over a mesh axis: rank
``d`` of ``n`` computes the frames ``[d·T/n, (d+1)·T/n)`` from its slab of
the waveform, which every rank holds whole (it is small beside the
features), so the slab and its ``win_length - hop`` samples of lookahead
(the halo) are a local slice. The chain is the plain one of ``ops/audio.py``
with the matmul DFT, as the JAX package's runs outside its kernels.

``gather=True`` all-gathers the mel frames and runs the dB / DCT tail on the
whole axis; ``gather=False`` leaves the features frame-sharded for the SP
BiLSTM, and MFCC's per-example dB reference becomes a maximum over the
ranks (an explicit ``all_reduce``, where JAX's XLA inserts a ``pmax``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mmbidaf_tpu_torch.ops.audio import frame_signal, log_power, melspectrogram, power_to_db
from mmbidaf_tpu_torch.ops.common import mm
from mmbidaf_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce


def make_sp_audio_frontend(mesh: Mesh, consts: dict, win_length: int, hop_length: int,
                           num_frames: int, feature: str = "mfcc", axis: str | None = None,
                           gather: bool = True):
    """Build ``frontend(signal [B, N]) → features``: ``[B, num_frames,
    n_feat]`` with ``gather=True``, else this rank's ``[B, num_frames/n,
    n_feat]`` slab. ``signal`` is the rank's batch rows of the waveform,
    whole along time."""
    axis = axis or mesh.axis_names[-1]
    n_dev = mesh.shape[axis]
    if num_frames % n_dev:
        raise ValueError(
            f"SP audio frontend: num_frames {num_frames} must be divisible by the "
            f"{n_dev}-device {axis!r} mesh axis — pad the frame bucket "
            f"(DataConfig.max_audio_frames) to a multiple of {n_dev}")
    if feature not in ("mfcc", "logmel"):
        raise ValueError(f"unknown feature {feature!r}")
    frames_per_dev = num_frames // n_dev
    group = mesh.group(axis)
    idx = mesh.coords[axis]

    def local_mel(signal: torch.Tensor) -> torch.Tensor:
        start = idx * frames_per_dev * hop_length
        slab_len = (frames_per_dev - 1) * hop_length + win_length
        frames = frame_signal(signal[:, start:start + slab_len], win_length, hop_length,
                              frames_per_dev)
        return melspectrogram(frames, consts)  # [B, frames_per_dev, n_mels]

    def frontend(signal: torch.Tensor) -> torch.Tensor:
        mel = local_mel(signal)
        if gather:
            mel = all_gather(mel, group, dim=1)
        if feature == "logmel":
            return torch.log(mel + 1e-6)
        if gather:
            return mm(power_to_db(mel), consts["dct"])
        # power_to_db against the per-example max over every rank's frames
        ref = all_reduce(log_power(mel).amax(dim=(-2, -1), keepdim=True), group,
                         dist.ReduceOp.MAX)
        return mm(power_to_db(mel, ref=ref), consts["dct"])

    return frontend
