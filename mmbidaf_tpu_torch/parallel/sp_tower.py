"""Flag-driven sequence-parallel audio tower — the port of
``mmbidaf_tpu.parallel.sp_tower``.

``MeshConfig.sp_audio`` routes the audio tower through the chain

    waveform [B, N] ── SP-MFCC (frame-sharded) ──> features  [B, T_a/n, n_mfcc]
                    ── SP-BiLSTM               ──> encodings [B, T_a/n, 2h]
                    ── ring BiDAF              ──> G_ta      [B, T_s/n, 8h]
                    ── gather over seq         ──> G_ta      [B, T_s, 8h]

with the frame axis sharded over the mesh's ``seq`` axis and never
gathered; the ring's output (a shard of the sentence axis) is gathered for
the fusion, which every rank of the axis then runs alike. The batch rows are
the rank's own (its data shard under DP), so DP × SP composes.

As in the JAX package, the SP frontend always takes the matmul DFT (it
ignores ``DataConfig.audio_fft``) and no hand kernel: K1, K2 and K3 give way
to the plain chain. The SP frontend and the ring compute in f32, the SP
BiLSTM in the compute dtype, and the tower's output is cast to it.

Dropout: the caller draws the similarity's masks at full shape from its
``torch.Generator``, as the path without a mesh draws them
(``models.mmbidaf.draw_dropout_masks``), and the tower takes this rank's
slices, so an SP run with dropout equals the port's single-device run up to
the ring's summation order.
"""

from __future__ import annotations

import torch

from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.models.mmbidaf import torch_dtype
from mmbidaf_tpu_torch.ops.audio import make_audio_frontend_consts
from mmbidaf_tpu_torch.parallel.audio_sp import make_sp_audio_frontend
from mmbidaf_tpu_torch.parallel.mesh import Mesh
from mmbidaf_tpu_torch.parallel.ring_attention import gather_seq, make_ring_bidaf, shard_seq
from mmbidaf_tpu_torch.parallel.sp_lstm import make_sp_bilstm


def sp_axes(mesh: Mesh, cfg: Config) -> tuple[str, tuple[str, ...] | None]:
    """(seq_axis, batch_axes) for the SP tower on this mesh: the ``seq``
    axis when the mesh has one, else its last axis (a pure-SP mesh built by
    hand); the batch axes are every other axis wider than 1 but ``model``."""
    m = cfg.mesh
    if m.seq_axis in mesh.axis_names:
        seq = m.seq_axis
    elif m.model_axis in mesh.axis_names:
        # the last-axis fallback would silently repurpose the TP weight
        # axis as sequence parallelism
        raise ValueError("sp_audio on a mesh with a 'model' (TP) axis needs an explicit"
                         " 'seq' axis: set MeshConfig.num_seq > 1")
    else:
        seq = mesh.axis_names[-1]
    batch = tuple(a for a in mesh.axis_names
                  if a not in (seq, m.model_axis) and mesh.shape[a] > 1)
    return seq, (batch or None)


def make_sp_audio_tower(mesh: Mesh, cfg: Config, use_batch_axis: bool = True):
    """Build ``audio_g_fn(params, text_enc, batch, drops=None) → G_ta [B, T_s,
    8h]``. ``batch`` carries this rank's rows of ``waveform [B, n_samples]``,
    ``aud_mask [B, T_a]`` and ``sent_mask [B, T_s]``, whole along their time
    axes; ``text_enc`` is the sentence tower's output; ``drops`` the
    ``(c_drop [B, T_s, 2h], q_drop [B, T_a, 2h])`` scaled keep masks of the
    similarity (training), or None. ``use_batch_axis`` is the JAX signature's:
    a rank's rows are whatever batch it was given (its data shard under DP,
    the whole request batch in serving without DP)."""
    d, m = cfg.data, cfg.model
    axis, _ = sp_axes(mesh, cfg)
    n = mesh.shape[axis]
    idx = mesh.coords[axis]
    consts = make_audio_frontend_consts(d.sample_rate, d.n_fft, d.win_length, d.n_mels,
                                        d.n_mfcc, d.fmin, d.fmax, device=mesh.device)
    frontends: dict[int, object] = {}

    def frontend_for(num_frames: int):
        fe = frontends.get(num_frames)
        if fe is None:
            fe = frontends[num_frames] = make_sp_audio_frontend(
                mesh, consts, d.win_length, d.hop_length, num_frames,
                feature=d.audio_features, axis=axis, gather=False)
        return fe

    frontend_for(d.max_audio_frames)  # validate the static bucket eagerly
    sp_lstm = make_sp_bilstm(mesh, axis=axis)
    ring = make_ring_bidaf(mesh, axis=axis)
    ring_drop = make_ring_bidaf(mesh, axis=axis, dropout=True)
    compute_dtype = torch_dtype(m.compute_dtype)

    def audio_g_fn(params, text_enc: torch.Tensor, batch, drops=None) -> torch.Tensor:
        aud_mask = batch["aud_mask"].float()
        T_a = aud_mask.shape[1]
        tl = T_a // n
        feats = frontend_for(T_a)(batch["waveform"].float())
        m_loc = aud_mask[:, idx * tl:(idx + 1) * tl]
        feats = feats * m_loc[:, :, None]
        # stacked aud_lstm: each layer runs the wavefront on the still
        # sharded frame axis (the encoders carry no inter-layer dropout)
        aud_p = params.aud_lstm
        enc = feats.to(compute_dtype)
        m_c = m_loc.to(compute_dtype)
        for lp in (aud_p.layers if hasattr(aud_p, "layers") else [aud_p]):
            enc = sp_lstm(lp, enc, m_c)
        sent_mask = batch["sent_mask"]
        T_s = sent_mask.shape[1]
        c_loc = shard_seq(text_enc, mesh, axis)
        cm_loc = shard_seq(sent_mask, mesh, axis)
        if drops is not None:
            c_drop, q_drop = drops
            cd = shard_seq(text_enc * c_drop.to(text_enc.dtype), mesh, axis)
            qd = enc * q_drop[:, idx * tl:(idx + 1) * tl].to(enc.dtype)
            g = ring_drop(params.att_aud, c_loc, enc, cd, qd, cm_loc, m_loc)
        else:
            g = ring(params.att_aud, c_loc, enc, cm_loc, m_loc)
        return gather_seq(g, mesh, axis, T_s).to(compute_dtype)

    return audio_g_fn
