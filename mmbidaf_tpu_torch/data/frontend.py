"""Raw inputs → model features on the device, and the end-to-end serving
program — the port of ``mmbidaf_tpu.data.frontend``.

Keyframes: matmul-form bilinear resize + VGG in the compute dtype (its
C_in >= 32 convs through the Winograd kernel K14 under
``use_winograd_conv``), features cast back to f32 and masked. Audio: framing (a strided view) → MFCC, through
the hand kernel when ``use_pallas_melspec`` is on. Text passes through.
"""

from __future__ import annotations

import copy
from typing import Mapping

import torch
from torch import nn

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode, torch_dtype
from mmbidaf_tpu_torch.ops import audio as audio_ops
from mmbidaf_tpu_torch.ops import vgg as vgg_ops
from mmbidaf_tpu_torch.utils.profiling import span

# Auto frame-chunking budget for the VGG stack's two live activation
# buffers, as a share of the card's memory. The JAX package budgets 14 GB of
# a 16 GB TPU (frontend.py:28); the share here leaves the rest of an 80 GB
# card to the weights, cuDNN workspaces and the allocator's slack.
_VGG_ACT_SHARE_OF_CARD = 0.4
# On the CPU (tests, small shapes) the JAX package's absolute budget stands.
_CPU_VGG_ACT_BUDGET = 14e9


def vgg_act_budget(device: torch.device) -> float:
    """Bytes the VGG activations may take before frames are chunked."""
    if device.type == "cuda":
        return _VGG_ACT_SHARE_OF_CARD * torch.cuda.get_device_properties(device).total_memory
    return _CPU_VGG_ACT_BUDGET


def _auto_vgg_chunk(n_frames: int, image_size: int, first_ch: int, itemsize: int,
                    budget: float) -> int:
    """Frame-chunk size for ``vgg_frame_chunk=0`` (auto): 0 (one pass) while
    the two-live-buffer estimate fits ``budget``, else the largest 128-multiple
    chunk that fits (or the raw fitting count when even 128 frames do not)."""
    per_frame = 2 * image_size * image_size * first_ch * itemsize
    if n_frames * per_frame <= budget:
        return 0
    fit = int(budget / per_frame)
    return fit // 128 * 128 or max(1, fit)


def vgg_frame_chunk(cfg: Config, n_frames: int, vgg_spec, device: torch.device) -> int:
    """Frames a VGG pass takes at once for ``n_frames`` frames (0: all):
    ``ModelConfig.vgg_frame_chunk``, or with 0 there the automatic choice for
    the card's memory (:func:`_auto_vgg_chunk`)."""
    chunk = cfg.model.vgg_frame_chunk
    if chunk == 0:
        itemsize = torch.finfo(torch_dtype(cfg.model.compute_dtype)).bits // 8
        chunk = _auto_vgg_chunk(n_frames, cfg.data.image_size,
                                next(c for c in vgg_spec if isinstance(c, int)), itemsize,
                                vgg_act_budget(device))
    return chunk


class Frontend(nn.Module):
    """Frontend params: ``vgg`` (when images are on) and the audio constants
    ``audio_consts`` (buffers rebuilt from the config, never loaded)."""

    def __init__(self, cfg: Config, vgg_spec, generator: torch.Generator, device):
        super().__init__()
        d = cfg.data
        consts = audio_ops.make_audio_frontend_consts(
            d.sample_rate, d.n_fft, d.win_length, d.n_mels, d.n_mfcc, d.fmin, d.fmax,
            device=device,
        )
        for name, t in consts.items():
            self.register_buffer(f"audio_{name}", t, persistent=False)
        if cfg.model.use_images:
            self.vgg = vgg_ops.VGG(vgg_spec, d.image_size, cfg.model.img_feat_dim, 3,
                                   generator, device)

    @property
    def audio_consts(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, f"audio_{k}") for k in ("cos", "sin", "mel_fb", "dct")}


def frontend_init(cfg: Config, vgg_spec=vgg_ops.VGG16_SPEC, device="cuda", seed: int = 1) -> Frontend:
    """Random VGG weights (torch.Generator, seeded) + the audio constants."""
    dev = resolve_device(device)
    return Frontend(cfg, vgg_spec, torch.Generator(device=dev).manual_seed(seed), dev)


def cast_vgg_weights(fe: Frontend, compute_dtype: str) -> Frontend:
    """A frontend whose (frozen) VGG weights are held in the compute dtype —
    equal to casting at every use; the audio constants stay f32."""
    dtype = torch_dtype(compute_dtype)
    if dtype == torch.float32 or not hasattr(fe, "vgg"):
        return fe
    out = copy.deepcopy(fe)
    out.vgg.to(dtype)
    return out


def apply_frontend(fe: Frontend, raw: Mapping[str, torch.Tensor], cfg: Config,
                   vgg_spec=vgg_ops.VGG16_SPEC, sp_audio: bool = False) -> dict:
    """Raw batch → model-ready feature batch.

    Raw schema: ``frames [B, T_i, H, W, 3] uint8``, ``waveform [B, N] f32``,
    ``text_ids``/``word_mask``/``sent_mask``/``img_mask``/``aud_mask``.
    Precomputed ``images`` / ``audio`` features pass through. With
    ``sp_audio`` (``MeshConfig.sp_audio``) the waveform passes through raw:
    the sequence-parallel tower (``parallel/sp_tower.py``) featurizes it
    inside the model, frame-sharded over the mesh's ``seq`` axis.
    """
    d, m = cfg.data, cfg.model
    out = {k: raw[k] for k in ("text_ids", "word_mask", "sent_mask") if k in raw}
    if m.use_images and "images" in raw and "frames" not in raw:
        out["images"], out["img_mask"] = raw["images"], raw["img_mask"]
    if m.use_audio and "audio" in raw and "waveform" not in raw:
        out["audio"], out["aud_mask"] = raw["audio"], raw["aud_mask"]
    if m.use_images and "frames" in raw:
        feats = frames_through_vgg(fe, raw["frames"], cfg, vgg_spec)
        out["images"] = masked_image_features(feats, raw["img_mask"])
        out["img_mask"] = raw["img_mask"]
    if m.use_audio and "waveform" in raw and sp_audio:
        out["waveform"], out["aud_mask"] = raw["waveform"], raw["aud_mask"]
    elif m.use_audio and "waveform" in raw:
        # the frame count follows the batch's audio axis, as in the JAX package
        with span("frontend.audio"):
            feats = audio_ops.waveform_to_features(
                raw["waveform"], fe.audio_consts, d.win_length, d.hop_length,
                raw["aud_mask"].shape[1], feature=d.audio_features,
                fused=m.use_pallas_melspec, fft=d.audio_fft,
            )
            out["audio"] = feats * raw["aud_mask"][:, :, None]
        out["aud_mask"] = raw["aud_mask"]
    return out


def frames_through_vgg(fe: Frontend, frames: torch.Tensor, cfg: Config, vgg_spec,
                       features=vgg_ops.vgg_features) -> torch.Tensor:
    """``[B, T_i, H, W, 3]`` uint8 frames → ``[B·T_i, fc]``: the resize and
    ``features`` (the whole stack, or ``vgg_ops.vgg_fc2_partial``) over
    frame chunks of ``vgg_frame_chunk``, in the compute dtype; each chunk's
    ``features`` in a span ``frontend.vgg``, beside the resize's own."""
    d, m = cfg.data, cfg.model
    compute_dtype = torch_dtype(m.compute_dtype)
    B, T_i = frames.shape[:2]
    flat = frames.reshape((B * T_i,) + tuple(frames.shape[2:]))
    vgg = fe.vgg
    if vgg.fc1_w.dtype != compute_dtype:
        vgg = copy.deepcopy(vgg).to(compute_dtype)
    step = vgg_frame_chunk(cfg, flat.shape[0], vgg_spec, flat.device) or flat.shape[0]
    chunks = []
    for i in range(0, flat.shape[0], step):
        images = vgg_ops.preprocess_frames(flat[i:i + step], d.image_size, compute_dtype)
        with span("frontend.vgg"):
            chunks.append(features(vgg, images, vgg_spec, winograd=m.use_winograd_conv))
    return torch.cat(chunks)


def masked_image_features(feats: torch.Tensor, img_mask: torch.Tensor) -> torch.Tensor:
    """``[B·T_i, fc]`` VGG features → ``[B, T_i, fc]`` f32, padded frames zeroed."""
    B, T_i = img_mask.shape
    return feats.float().reshape(B, T_i, -1) * img_mask[:, :, None]


def make_end_to_end_decode(cfg: Config, vgg_spec=vgg_ops.VGG16_SPEC, audio_g_fn=None,
                           mode: str = "greedy", topk: int = 4):
    """The serving program: raw video batch → ``(log_probs [B, K, T_s],
    picks [B, K])``, greedy; ``mode="beam"``: beam search of width ``topk``,
    the best beam's total log-prob ``[B]`` in the place of the log-probs.
    ``end_to_end(model, frontend, raw)`` runs eagerly under
    ``torch.inference_mode``. ``audio_g_fn`` routes the audio tower through
    the sequence-parallel chain (``MeshConfig.sp_audio``); the frontend then
    passes the raw waveform through to it."""
    if mode not in ("greedy", "beam"):
        raise ValueError(f"make_end_to_end_decode: mode must be 'greedy' or 'beam', got {mode!r}")

    @torch.inference_mode()
    def end_to_end(model, fe: Frontend, raw: Mapping[str, torch.Tensor]):
        batch = apply_frontend(fe, raw, cfg, vgg_spec, sp_audio=audio_g_fn is not None)
        return mmbidaf_decode(model, batch, cfg, mode=mode, topk=topk, audio_g_fn=audio_g_fn)

    return end_to_end
