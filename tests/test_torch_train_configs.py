"""The capability configs' training blocks on the CPU: the shapes that
``examples/configs/config1…4_*.json`` train (64 sentences, 64 keyframes,
512 audio frames) against the JAX package.

On the card, K7 and K8 take their tiled route at these shapes
(``bidaf_kernel.drop_route``; ``chip_smoke.py`` phase 14 runs them at the
published widths); here the wrappers run their plain versions, which are
held against JAX's ``bidaf_attention_fused_dropout`` and its VJP (the
Pallas kernels in interpret mode) at T_c=64 and T_q in {64, 512} with a
narrow D, and one drop-0 train step at config 4's sentence count against
JAX's ``make_train_step`` with narrow widths. Bounds: the output within
2e-5, gradients within ``atol=5e-5, rtol=1e-4`` (``test_torch_train.py``'s),
the step's loss and grad norm within ``rtol=1e-5`` and every parameter and
EMA leaf within 1e-6 (adadelta, as ``test_train_step_matches_jax``).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import config_from_json as j_config_from_json
from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data.synthetic import random_word_vectors as j_word_vectors
from mmbidaf_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu.ops.bidaf import bidaf_init
from mmbidaf_tpu.ops.pallas.bidaf_kernel import bidaf_attention_fused_dropout as j_bidaf_drop
from mmbidaf_tpu.train import loop as j_loop
from mmbidaf_tpu_torch.config import config_from_json, tiny_test_config
from mmbidaf_tpu_torch.interop.from_jax import flatten_pytree, load_pytree, train_state_from_jax
from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
from mmbidaf_tpu_torch.train import loop

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ("config1_text_only.json", "config2_text_image.json", "config3_text_audio.json",
           "config4_trimodal.json")
GRAD_TOL = {"atol": 5e-5, "rtol": 1e-4}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", CONFIGS)
def test_capability_configs_train_on_the_tiled_route(name):
    """Each published config loads equal in both packages; at its widths
    (hidden 128: D=256) every BiDAF block it trains has T_c=64, which no
    cluster block of K7/K8 holds, so K7/K8's route is the tiled one."""
    path = str(REPO / "examples" / "configs" / name)
    cfg, j_cfg = config_from_json(path), j_config_from_json(path)
    assert dataclasses.asdict(cfg) == json.loads(json.dumps(dataclasses.asdict(j_cfg)))
    d, m = cfg.data, cfg.model
    assert (m.hidden_size, d.max_sentences, d.max_words, m.drop_prob) == (128, 64, 32, 0.2)
    T_qs = ([d.max_keyframes] if m.use_images else []) + ([d.max_audio_frames] if m.use_audio else [])
    for T_q in T_qs or [d.max_sentences]:  # text-only: self-attention over the sentences
        with pytest.raises(ValueError, match="no BiDAF cluster plan"):
            bk.drop_plan(d.max_sentences, T_q, 2 * m.hidden_size)
        assert bk.drop_route(d.max_sentences, T_q, 2 * m.hidden_size) == "tiled"


@pytest.mark.parametrize("dropped", [True, False], ids=["dropout", "trainable"])
@pytest.mark.parametrize("T_q", [64, 512])
def test_config_blocks_match_pallas(T_q, dropped):
    """The blocks of configs 1–4 (T_c=64 sentences against 64 keyframes or
    512 audio frames; config 1's self-attention is the T_q=64 case) with a
    narrow D=8: the same injected cd/qd on both sides, a fully masked row
    on each side; output and every gradient against JAX's Pallas pair."""
    rng = np.random.default_rng(T_q)
    B, T_c, D = 3, 64, 8
    jp = dict(bidaf_init(jax.random.key(3), D), bias=jnp.float32(0.2))
    c = rng.standard_normal((B, T_c, D)).astype(np.float32)
    q = rng.standard_normal((B, T_q, D)).astype(np.float32)
    c_mask = (np.arange(T_c)[None] < np.array([64, 0, 37])[:, None]).astype(np.float32)
    q_mask = (np.arange(T_q)[None] < np.array([T_q, T_q // 3, 0])[:, None]).astype(np.float32)
    keep = lambda shape: (rng.random(shape) < 0.8).astype(np.float32) / 0.8  # noqa: E731
    m_c, m_q = keep(c.shape), keep(q.shape)
    w = rng.standard_normal((B, T_c, 4 * D)).astype(np.float32)

    def j_loss(p, cc, qq, cd, qd):
        if not dropped:
            cd, qd = cc, qq
        out = j_bidaf_drop(p, cc, qq, cd, qd, jnp.asarray(c_mask), jnp.asarray(q_mask))
        return (out * w).sum(), out

    j_args = [jnp.asarray(v) for v in (c, q, c * m_c, q * m_q)]
    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jp, *j_args)
    port = BiDAFParams(D, torch.Generator().manual_seed(0), "cpu")
    load_pytree(port, _np(jp))
    for p in port.parameters():
        p.requires_grad_(True)
    ct, qt = _t(c).requires_grad_(True), _t(q).requires_grad_(True)
    cd, qd = _t(c * m_c).requires_grad_(True), _t(q * m_q).requires_grad_(True)
    if dropped:
        out = bk.bidaf_attention_fused_dropout(port, ct, qt, cd, qd, _t(c_mask), _t(q_mask))
    else:
        out = bk.bidaf_attention_fused_trainable(port, ct, qt, _t(c_mask), _t(q_mask))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-5)
    ours = [ct.grad, qt.grad] + ([cd.grad, qd.grad] if dropped else [])
    for o, r in zip(ours, j_grads[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **GRAD_TOL)
    for k, g in flatten_pytree(_np(j_grads[0])).items():
        np.testing.assert_allclose(port.get_parameter(k).grad.numpy(), g, **GRAD_TOL, err_msg=k)


def _sixty_four_sentences(cfg):
    """The tiny test config at config 4's sentence count (64) and keyframe
    count (64), both towers on, drop 0, kernel flags on (the plain versions
    on the CPU)."""
    data = dataclasses.replace(cfg.data, max_sentences=64, max_keyframes=64)
    model = dataclasses.replace(cfg.model, drop_prob=0.0, use_images=True, use_audio=True,
                                use_pallas_attention=True, use_pallas_lstm=True)
    return dataclasses.replace(cfg, data=data, model=model)


def test_step_at_config4_sentence_count_matches_jax():
    """One drop-0 train step (adadelta, flat updates) at T_s=64 against
    JAX's ``make_train_step`` from the same weights and batch: loss, grad
    norm, then every parameter and EMA leaf."""
    j_cfg, cfg = _sixty_four_sentences(j_tiny_config()), _sixty_four_sentences(tiny_test_config())
    rng = np.random.default_rng(2)
    wv = j_word_vectors(rng, j_cfg.data.vocab_size, j_cfg.model.emb_dim)
    params = j_init(jax.random.key(2), j_cfg, jnp.asarray(wv))
    batch = j_synthetic_batch(rng, j_cfg, batch_size=3)
    assert batch["text_ids"].shape[1] == 64
    np_params = _np(params)  # JAX's step donates the state's buffers
    j_state, j_m = j_loop.make_train_step(j_cfg)(j_loop.init_train_state(jax.random.key(1), params,
                                                                         j_cfg),
                                                 {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_state_from_jax(np_params, np_params, cfg, device="cpu")
    state, m = loop.make_train_step(cfg)(state, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(j_m["grad_norm"]), rtol=1e-5)
    for tree, module in ((j_state.params, state.params), (j_state.ema_params, state.ema_params)):
        ours = module.state_dict()
        for k, v in flatten_pytree(_np(tree)).items():
            np.testing.assert_allclose(ours[k].detach().numpy(), v, atol=1e-6, err_msg=k)
