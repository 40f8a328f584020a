"""The port's training path on the CPU against the JAX package, plus the
repairs that make the port stand on its own (its own host modules, the card
by default).

The same seeded numpy inputs and the same weights (carried by
``interop.from_jax``) go through both packages. On CPU tensors the K5-K8
wrappers run their plain versions, which are held here against the JAX
trainable kernels run in interpret mode. Dropout masks cannot match the
JAX random stream: the kernel tests inject the same masks on both sides,
the dropout tests check statistics, and the step tests run at drop_prob 0.

Tolerances, f32 on both sides with sums in different orders (XLA vs
PyTorch): forward outputs ``atol=2e-5`` on O(1) values; gradients
``atol=5e-5, rtol=1e-4``, the bound the JAX package holds its own Pallas
gradients to against its jnp path (the gradients are sums over steps, rows
and the batch); loss and grad norm ``rtol=1e-5``; parameters and EMA after
two steps ``atol=1e-6`` (an adadelta step moves a parameter by at most
lr·sqrt(10)·1e-3 ≈ 1.6e-3, so 1e-6 is a relative 6e-4 of the move, and an
adam step by at most lr); remat against no remat ``atol=1e-6`` (the same
arithmetic recomputed).
"""

import dataclasses
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data.synthetic import random_word_vectors as j_word_vectors
from mmbidaf_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from mmbidaf_tpu.models.mmbidaf import mmbidaf_apply as j_apply
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu.ops.bidaf import bidaf_init
from mmbidaf_tpu.ops.lstm import bilstm_init
from mmbidaf_tpu.ops.pallas.bidaf_kernel import bidaf_attention_fused_dropout as j_bidaf_drop
from mmbidaf_tpu.ops.pallas.lstm_kernel import bilstm_pallas_trainable
from mmbidaf_tpu.train import loop as j_loop
from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.interop.from_jax import flatten_pytree, load_pytree, train_state_from_jax
from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_apply, mmbidaf_init
from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel
from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams
from mmbidaf_tpu_torch.train import loop

GEN = torch.Generator().manual_seed(0)
GRAD_TOL = {"atol": 5e-5, "rtol": 1e-4}
REPO = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(kernels=False, **train):
    """The JAX and the port configs of one tiny setting at drop_prob 0; the
    JAX side runs its plain path (equal to its Pallas path in f32)."""
    j_cfg = j_tiny_config()
    j_cfg = dataclasses.replace(j_cfg, train=dataclasses.replace(j_cfg.train, **train))
    cfg = tiny_test_config()
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **train),
        model=dataclasses.replace(cfg.model, use_pallas_lstm=kernels, use_pallas_attention=kernels))
    return j_cfg, cfg


# ---------------------------------------------------------------------------
# K5/K6 and K7/K8: the plain versions against the JAX trainable kernels.
# ---------------------------------------------------------------------------


def test_trainable_bilstm_matches_pallas(rng):
    """Both directions (the reverse one too), a fully masked row, and
    non-zero cotangents on the final h and c."""
    B, T, D, h = 4, 9, 6, 8
    jp = bilstm_init(jax.random.key(7), D, h)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([9, 4, 0, 7])[:, None]).astype(np.float32)
    w_out = rng.standard_normal((B, T, 2 * h)).astype(np.float32)
    w_h = rng.standard_normal((B, 2 * h)).astype(np.float32)

    def j_loss(p, xx):
        out, (h_n, c_n) = bilstm_pallas_trainable(p, xx, jnp.asarray(mask), interpret=True)
        return (out * w_out).sum() + (h_n * w_h).sum() + (c_n ** 2).sum(), (out, h_n, c_n)

    (j_l, j_outs), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    port = BiLSTMParams(D, h, GEN, "cpu")
    load_pytree(port, _np(jp))
    for p in port.parameters():
        p.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    before = (lstm_kernel.bilstm_train_forward.launches, lstm_kernel.bilstm_bptt.launches)
    out, (h_n, c_n) = lstm_kernel.bilstm_cuda_trainable(port, xt, _t(mask))
    loss = (out * _t(w_out)).sum() + (h_n * _t(w_h)).sum() + (c_n ** 2).sum()
    loss.backward()
    for o, r in zip((out, h_n, c_n), j_outs):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=2e-5)
    assert not out[2].any() and not h_n[2].any() and not c_n[2].any()
    np.testing.assert_allclose(loss.item(), float(j_l), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_grads[1]), **GRAD_TOL)
    for k, g in flatten_pytree(_np(j_grads[0])).items():
        np.testing.assert_allclose(port.get_parameter(k).grad.numpy(), g, **GRAD_TOL, err_msg=k)
    # the plain versions on CPU tensors are not launches
    assert (lstm_kernel.bilstm_train_forward.launches, lstm_kernel.bilstm_bptt.launches) == before


@pytest.mark.parametrize("dropped", [True, False], ids=["dropout", "trainable"])
def test_bidaf_dropout_matches_pallas(rng, dropped):
    """The same injected cd/qd on both sides (cd = c, qd = q is the
    dropout-free trainable block); output and all six gradients (c, q, cd,
    qd and the parameters), with a fully masked row on each side."""
    B, T_c, T_q, D = 3, 6, 5, 8
    jp = dict(bidaf_init(jax.random.key(14), D), bias=jnp.float32(0.3))
    c = rng.standard_normal((B, T_c, D)).astype(np.float32)
    q = rng.standard_normal((B, T_q, D)).astype(np.float32)
    c_mask = (np.arange(T_c)[None] < np.array([6, 0, 3])[:, None]).astype(np.float32)
    q_mask = (np.arange(T_q)[None] < np.array([5, 2, 0])[:, None]).astype(np.float32)
    keep = lambda shape: (rng.random(shape) < 0.7).astype(np.float32) / 0.7  # noqa: E731
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
    port = BiDAFParams(D, GEN, "cpu")
    load_pytree(port, _np(jp))
    for p in port.parameters():
        p.requires_grad_(True)
    ct, qt = _t(c).requires_grad_(True), _t(q).requires_grad_(True)
    cd, qd = _t(c * m_c).requires_grad_(True), _t(q * m_q).requires_grad_(True)
    if dropped:
        out = bidaf_kernel.bidaf_attention_fused_dropout(port, ct, qt, cd, qd, _t(c_mask), _t(q_mask))
    else:
        out = bidaf_kernel.bidaf_attention_fused_trainable(port, ct, qt, _t(c_mask), _t(q_mask))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-5)
    ours = [ct.grad, qt.grad] + ([cd.grad, qd.grad] if dropped else [])
    for o, r in zip(ours, j_grads[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **GRAD_TOL)
    for k, g in flatten_pytree(_np(j_grads[0])).items():
        np.testing.assert_allclose(port.get_parameter(k).grad.numpy(), g, **GRAD_TOL, err_msg=k)


def test_bptt_reference_equals_autograd(rng):
    """K6's plain version is the gradient of K5's plain version."""
    B, T, H = 3, 6, 5
    gates = _t(rng.standard_normal((B, T, 8 * H)).astype(np.float32)).requires_grad_(True)
    w_h = _t(rng.standard_normal((2, H, 4 * H)).astype(np.float32) * 0.3).requires_grad_(True)
    mask = _t((np.arange(T)[None] < np.array([6, 0, 2])[:, None]).astype(np.float32))
    dout, dh, dc = (_t(rng.standard_normal(s).astype(np.float32))
                    for s in ((B, T, 2 * H), (B, 2 * H), (B, 2 * H)))
    out, h, c, h_seq, c_seq = lstm_kernel.bilstm_train_forward_reference(gates, mask, w_h)
    g_gates, g_wh = torch.autograd.grad((out * dout).sum() + (h * dh).sum() + (c * dc).sum(),
                                        [gates, w_h])
    dgates, dw_h = lstm_kernel.bilstm_bptt_reference(gates.detach(), mask, w_h.detach(),
                                                     h_seq.detach(), c_seq.detach(), dout, dh, dc)
    np.testing.assert_allclose(dgates.numpy(), g_gates.numpy(), atol=1e-6)
    np.testing.assert_allclose(dw_h.numpy(), g_wh.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# The model and the train step against JAX.
# ---------------------------------------------------------------------------


def _weights(cfg_j, seed=2):
    rng = np.random.default_rng(seed)
    wv = j_word_vectors(rng, cfg_j.data.vocab_size, cfg_j.model.emb_dim)
    params = j_init(jax.random.key(seed), cfg_j, jnp.asarray(wv))
    return params, rng


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel_flags_on", "kernel_flags_off"])
def test_loss_and_grads_match_jax(kernels):
    """Teacher-forced loss and the gradient of every parameter (the frozen
    table gets none) on the training path at drop_prob 0."""
    j_cfg, cfg = _cfgs(kernels)
    params, rng = _weights(j_cfg)
    batch = j_synthetic_batch(rng, j_cfg, batch_size=3)

    def j_loss(p):
        log_p = j_apply(p, {k: jnp.asarray(v) for k, v in batch.items()}, j_cfg,
                        rng=jax.random.key(5))
        return j_loop.nll_loss(log_p, jnp.asarray(batch["targets"]), jnp.asarray(batch["target_mask"]))

    j_l, j_g = jax.value_and_grad(j_loss)(params)
    state = train_state_from_jax(_np(params), _np(params), cfg, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    log_p = mmbidaf_apply(state.params, tb, cfg, generator=state.generator)
    loss_t = loop.nll_loss(log_p, tb["targets"], tb["target_mask"])
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(j_l), rtol=1e-5)
    for k, g in flatten_pytree(_np(j_g)).items():
        p = state.params.get_parameter(k)
        if loop.is_frozen(k):
            assert p.grad is None and not np.any(g)
            continue
        np.testing.assert_allclose(p.grad.numpy(), g, **GRAD_TOL, err_msg=k)


STEP_CASES = {
    "adadelta_flat_kernels": ({}, True),
    "accum2_clip_triggers": ({"grad_accum_steps": 2, "max_grad_norm": 1e-3}, True),
    "adam_warmup_cosine_tree_l2": ({"optimizer": "adam", "lr": 1e-2, "warmup_steps": 1,
                                    "lr_schedule": "cosine", "decay_steps": 10,
                                    "flat_updates": False, "l2_wd": 1e-3}, False),
    "adadelta_exponential_warmup_tree": ({"lr_schedule": "exponential", "warmup_steps": 2,
                                          "decay_steps": 3, "flat_updates": False}, False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    """Two steps of the port's train step against JAX's ``make_train_step``
    from the same weights and batch: loss and grad norm of each step, then
    every parameter and EMA leaf. Under adam the first steps are sign-like
    (``m̂/sqrt(v̂) = g/|g|`` while the gradient repeats), so an entry whose
    gradient is within rounding of zero — a BiDAF block's scalar bias always
    is, both softmaxes being invariant to a shift of S — may step by up to lr
    either way: there, 99% of the entries are held to ``atol=1e-6`` and all
    to the sum of the learning rates (``test_optimizer_matches_optax`` holds
    the update arithmetic itself exactly)."""
    train, kernels = STEP_CASES[case]
    j_cfg, cfg = _cfgs(kernels, **train)
    params, rng = _weights(j_cfg)
    batch = j_synthetic_batch(rng, j_cfg, batch_size=4)
    batch["target_mask"][1, -1] = 0.0  # unequal valid-step counts across microbatches
    j_state = j_loop.init_train_state(jax.random.key(1), params, j_cfg)
    j_step = j_loop.make_train_step(j_cfg)
    state = train_state_from_jax(_np(params), _np(params), cfg, device="cpu")
    step = loop.make_train_step(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    for i in range(2):
        j_state, j_m = j_step(j_state, jb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(j_m["grad_norm"]), rtol=1e-5)
    if train.get("max_grad_norm"):
        assert float(j_m["grad_norm"]) > train["max_grad_norm"]  # the clip triggered
    assert state.step == int(j_state.step) == 2
    lr_sum = sum(loop.make_lr_schedule(cfg)(i) for i in range(2))
    for tree, module in ((j_state.params, state.params), (j_state.ema_params, state.ema_params)):
        ours = module.state_dict()
        flat = flatten_pytree(_np(tree))
        if train.get("optimizer") != "adam":
            for k, v in flat.items():
                np.testing.assert_allclose(ours[k].detach().numpy(), v, atol=1e-6, err_msg=k)
            continue
        diff = np.concatenate([np.abs(ours[k].detach().numpy() - v).ravel() for k, v in flat.items()])
        assert np.mean(diff <= 1e-6) >= 0.99 and diff.max() <= 2 * lr_sum
    assert state.ema_params.embedding.table is state.params.embedding.table


@pytest.mark.parametrize("schedule", ["constant", "cosine", "exponential"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(schedule, warmup):
    j_cfg, cfg = _cfgs(lr=0.7, lr_schedule=schedule, warmup_steps=warmup, decay_steps=5,
                       lr_min_ratio=0.1)
    ours, ref = loop.make_lr_schedule(cfg), j_loop.make_lr_schedule(j_cfg)
    for count in range(12):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, err_msg=str(count))


OPT_CASES = {
    "adadelta_flat_clip": {"max_grad_norm": 0.5},
    "adadelta_tree_l2": {"flat_updates": False, "l2_wd": 1e-2, "max_grad_norm": 1e3},
    "adam_flat_l2_warmup": {"optimizer": "adam", "lr": 1e-3, "l2_wd": 1e-2, "warmup_steps": 2,
                            "lr_schedule": "cosine", "decay_steps": 5},
    "adam_tree_clip": {"optimizer": "adam", "lr": 1e-3, "flat_updates": False,
                       "max_grad_norm": 0.5},
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    """The same gradients (unit-normal, so no entry is near rounding noise)
    through the port's optimizer and JAX's optax chain, three updates: the
    parameters after each. Clipping follows optax (``g·max_norm/norm`` only
    at ``norm >= max_norm``), not ``clip_grad_norm_`` (``norm + 1e-6``,
    always); the frozen table is not updated."""
    j_cfg, cfg = _cfgs(**OPT_CASES[case])
    params, rng = _weights(j_cfg)
    model = train_state_from_jax(_np(params), _np(params), cfg, device="cpu").params
    opt = loop.make_optimizer(cfg)
    state = opt.init(model)
    tx = j_loop.make_optimizer(j_cfg)
    j_params, j_state = params, tx.init(params)
    names = list(flatten_pytree(_np(params)))
    for _ in range(3):
        g_np = {k: rng.standard_normal(np.shape(v)).astype(np.float32) * 0.3
                for k, v in flatten_pytree(_np(params)).items()}
        g_np = {k: np.zeros_like(v) if loop.is_frozen(k) else v for k, v in g_np.items()}
        leaves = jax.tree_util.tree_leaves_with_path(params)
        grads_tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [jnp.asarray(g_np[k]) for k in names])
        assert len(leaves) == len(names)
        updates, j_state = tx.update(grads_tree, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.update(model, [_t(g_np[n]) for n, _ in loop.trainable_parameters(model)], state)
        ours = model.state_dict()
        for k, v in flatten_pytree(_np(j_params)).items():
            np.testing.assert_allclose(ours[k].numpy(), v, rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# Dropout: statistics, and the same masks under remat.
# ---------------------------------------------------------------------------


def test_dropout_statistics():
    """The kept fraction is 1 - drop_prob and kept values are scaled by
    1/keep; the masks of one forward have the operands' shapes and differ
    from step to step (the generator advances)."""
    from mmbidaf_tpu_torch.models.mmbidaf import draw_dropout_masks
    from mmbidaf_tpu_torch.ops.common import dropout_mask

    g = torch.Generator().manual_seed(3)
    m = dropout_mask((400, 500), 0.2, g, "cpu")
    assert set(np.unique(m.numpy()).tolist()) == {0.0, np.float32(1 / 0.8)}
    assert abs(float((m > 0).float().mean()) - 0.8) < 0.005
    assert abs(float(m.mean()) - 1.0) < 0.01

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, drop_prob=0.3))
    batch = {k: _t(v) for k, v in j_synthetic_batch(np.random.default_rng(0), j_tiny_config(), 4).items()}
    first = draw_dropout_masks(batch, cfg, g)
    second = draw_dropout_masks(batch, cfg, g)
    B, T_s, W = batch["text_ids"].shape
    D = 2 * cfg.model.hidden_size
    assert first["emb"].shape == (B, T_s, W, cfg.model.emb_dim)
    assert first["img"][1].shape == (B, cfg.data.max_keyframes, D)
    assert first["aud"][1].shape == (B, cfg.data.max_audio_frames, D)
    kept = torch.cat([t.reshape(-1) for t in _leaves(first)]) > 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    assert not torch.equal(first["emb"], second["emb"])


def _leaves(masks):
    return [t for v in masks.values() for t in (v if isinstance(v, tuple) else (v,))]


def test_embedding_dropout_drops_glove_rows_before_projection():
    from mmbidaf_tpu_torch.models.embedding import embedding_apply

    cfg = tiny_test_config()
    wv = j_word_vectors(np.random.default_rng(1), cfg.data.vocab_size, cfg.model.emb_dim)
    model = mmbidaf_init(cfg, wv, "cpu")
    ids = torch.tensor([[3, 4, 5]])
    zero = torch.zeros(1, 3, cfg.model.emb_dim)
    with torch.no_grad():
        # all dropped: the projection sees zeros, as for the PAD row
        np.testing.assert_allclose(embedding_apply(model.embedding, ids, zero).numpy(),
                                   embedding_apply(model.embedding, torch.zeros_like(ids)).numpy())
        two = torch.full((1, 3, cfg.model.emb_dim), 2.0)
        scaled = embedding_apply(model.embedding, ids, two)
        assert not torch.allclose(scaled, embedding_apply(model.embedding, ids))


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel_flags_on", "kernel_flags_off"])
def test_remat_gives_the_same_grads_with_dropout(kernels):
    """``remat_towers`` (torch.utils.checkpoint) recomputes the towers with
    the masks drawn before them: the same loss and gradients as without."""
    grads = []
    for remat in (False, True):
        cfg = tiny_test_config()
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, drop_prob=0.3, use_pallas_lstm=kernels,
                                           use_pallas_attention=kernels),
            train=dataclasses.replace(cfg.train, remat_towers=remat))
        rng = np.random.default_rng(4)
        wv = j_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
        state = loop.init_train_state(mmbidaf_init(cfg, wv, "cpu", seed=4), cfg, seed=9)
        batch = {k: _t(v) for k, v in j_synthetic_batch(rng, j_tiny_config(), 3).items()}
        log_p = mmbidaf_apply(state.params, batch, cfg, generator=state.generator)
        loss = loop.nll_loss(log_p, batch["targets"], batch["target_mask"])
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone() for n, p in loop.trainable_parameters(state.params)}))
    (l0, g0), (l1, g1) = grads
    assert l0 == pytest.approx(l1, rel=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), atol=1e-6, err_msg=n)


def test_bf16_gradients_reach_the_f32_parameters():
    """Under compute_dtype bfloat16 the cast is differentiable: every
    trainable f32 parameter gets a finite f32 gradient that points the way
    the f32 gradient does."""
    grads = {}
    for dtype in ("float32", "bfloat16"):
        cfg = tiny_test_config()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype, use_pallas_lstm=True, use_pallas_attention=True))
        rng = np.random.default_rng(6)
        wv = j_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
        state = loop.init_train_state(mmbidaf_init(cfg, wv, "cpu", seed=6), cfg)
        batch = {k: _t(v) for k, v in j_synthetic_batch(rng, j_tiny_config(), 3).items()}
        log_p = mmbidaf_apply(state.params, batch, cfg, generator=state.generator)
        loop.nll_loss(log_p, batch["targets"], batch["target_mask"]).backward()
        grads[dtype] = {n: p.grad for n, p in loop.trainable_parameters(state.params)}
    for n, g in grads["bfloat16"].items():
        assert g is not None and g.dtype == torch.float32 and bool(torch.isfinite(g).all()), n
    flat = [torch.cat([g.reshape(-1) for g in grads[d].values()]) for d in ("float32", "bfloat16")]
    cos = torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0)
    assert float(cos) > 0.9


# ---------------------------------------------------------------------------
# Checkpoints and the CLI.
# ---------------------------------------------------------------------------


def _tiny_state(seed=0, **train):
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, drop_prob=0.2),
                              train=dataclasses.replace(cfg.train, **train))
    rng = np.random.default_rng(seed)
    wv = j_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    batch = {k: _t(v) for k, v in j_synthetic_batch(rng, j_tiny_config(), 4).items()}
    return cfg, loop.init_train_state(mmbidaf_init(cfg, wv, "cpu", seed=seed), cfg, seed + 1), batch


def test_checkpoint_restores_the_run_and_keeps_the_best(tmp_path):
    """A restored state continues exactly as the original (params,
    optimizer state, EMA, dropout generator); ranked saves are pruned to the
    best k, unranked ones kept."""
    from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager

    cfg, state, batch = _tiny_state()
    step = loop.make_train_step(cfg)
    mgr = CheckpointManager(tmp_path / "ck", max_checkpoints=2, metric_name="loss", maximize=False)
    for loss in (3.0, 1.0, 2.0):
        state, _ = step(state, batch)
        mgr.save(state, {"loss": loss})
    state, _ = step(state, batch)
    mgr.save(state)  # unranked
    assert mgr.steps() == [2, 3, 4] and mgr.latest_step() == 4
    _, fresh, _ = _tiny_state()
    restored = mgr.restore_latest(fresh)
    assert restored.step == 4
    state, m0 = step(state, batch)
    restored, m1 = step(restored, batch)
    assert float(m0["loss"]) == float(m1["loss"])
    for (n, a), (_, b) in zip(state.params.named_parameters(), restored.params.named_parameters()):
        assert torch.equal(a, b), n
    for (n, a), (_, b) in zip(state.ema_params.named_parameters(), restored.ema_params.named_parameters()):
        assert torch.equal(a, b), n


def test_cli_trains_logs_and_resumes(tmp_path):
    import json

    from mmbidaf_tpu_torch.train import cli

    cfg = tiny_test_config()
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(cfg)))
    args = ["--config_json", str(cfg_path), "--device", "cpu", "--eval_steps", "2",
            "--save_dir", str(tmp_path), "--name", "run"]
    cli.main(args + ["--num_steps", "3"])
    run = tmp_path / "run"
    index = json.loads((run / "ckpts" / "index.json").read_text())
    assert set(index) == {"2", "3"} and index["3"] is None and "loss" in index["2"]
    cli.main(args + ["--num_steps", "4"])
    logs = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logs if "eval_loss" in r] == [2, 4]
    assert all(np.isfinite(r.get("loss", 0.0)) for r in logs)
    with pytest.raises(SystemExit, match="needs raw waveform batches"):  # train.py's check
        cli.main(args + ["--sp_audio"])


# ---------------------------------------------------------------------------
# The repairs: the port's own host modules, the card by default.
# ---------------------------------------------------------------------------


def test_config_matches_jax():
    """The port's config dataclasses have the JAX ones' fields and defaults."""
    import mmbidaf_tpu.config as jc

    import mmbidaf_tpu_torch.config as tc

    for name in ("ModelConfig", "DataConfig", "TrainConfig", "MeshConfig", "Config"):
        ours, theirs = getattr(tc, name), getattr(jc, name)
        assert [(f.name, f.type) for f in dataclasses.fields(ours)] == \
            [(f.name, f.type) for f in dataclasses.fields(theirs)], name
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs()), name
    assert dataclasses.asdict(tc.tiny_test_config()) == dataclasses.asdict(jc.tiny_test_config())
    d = {"model": {"hidden_size": 12}, "train": {"lr": 0.1}}
    assert dataclasses.asdict(tc.config_from_dict(d)) == dataclasses.asdict(jc.config_from_dict(d))


def test_host_modules_match_jax(tmp_path):
    """Synthetic batches, word vectors, transcript encoding, summaries and
    asset decoding give the JAX package's results."""
    import importlib.util

    from mmbidaf_tpu.data import text as j_text
    from mmbidaf_tpu.data import video as j_video
    from mmbidaf_tpu.data import vocab as j_vocab
    from mmbidaf_tpu.train import metrics as j_metrics
    from mmbidaf_tpu_torch.data import synthetic, text, video, vocab
    from mmbidaf_tpu_torch.train import metrics

    cfg = tiny_test_config()
    ours = synthetic.synthetic_batch(np.random.default_rng(3), cfg, 5)
    theirs = j_synthetic_batch(np.random.default_rng(3), j_tiny_config(), 5)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    np.testing.assert_array_equal(synthetic.random_word_vectors(np.random.default_rng(1), 50, 7),
                                  j_word_vectors(np.random.default_rng(1), 50, 7))
    sents = ["The cat sat.", "A dog ran far away!", "Why?"]
    w2i = vocab.build_vocab([text.word_tokenize(s) for s in sents], max_size=8)
    assert w2i == j_vocab.build_vocab([j_text.word_tokenize(s) for s in sents], max_size=8)
    enc, j_enc = text.encode_sentences(sents, w2i, 4, 3), j_text.encode_sentences(sents, w2i, 4, 3)
    for k in ("text_ids", "word_mask", "sent_mask"):
        np.testing.assert_array_equal(enc[k], j_enc[k])
    picks = np.array([2, 0, 2, 9])
    assert metrics.summary_from_picks(picks, sents) == j_metrics.summary_from_picks(picks, sents)
    assert metrics.batch_rouge([picks], [sents], [sents[0]]) == \
        j_metrics.batch_rouge([picks], [sents], [sents[0]])

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_corpus(str(tmp_path), videos=1, sentences=4, frames=5, seconds=0.3, seed=1)
    vd = str(next(tmp_path.iterdir()))
    a = video.load_video_assets(vd, 4, 3000, keyframe_policy="shot_change")
    b = j_video.load_video_assets(vd, 4, 3000, keyframe_policy="shot_change")
    for k in b:
        if isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _entry_points():
    cfg = tiny_test_config()
    wv = np.zeros((cfg.data.vocab_size, cfg.model.emb_dim), np.float32)

    def jax_params():
        params = _np(j_init(jax.random.key(0), j_tiny_config(), jnp.asarray(wv)))
        return params

    def summarizer_from_jax():
        from mmbidaf_tpu.data.frontend import frontend_init as j_fe
        from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
        from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
        from mmbidaf_tpu_torch.serving import Summarizer

        fe = _np(j_fe(jax.random.key(1), j_tiny_config(), vgg_spec=J_TINY))
        Summarizer.from_jax_params(jax_params(), fe, {}, cfg, vgg_spec=TINY_SPEC)

    def frontend_from_jax():
        from mmbidaf_tpu.data.frontend import frontend_init as j_fe
        from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
        from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax as f
        from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC

        f(_np(j_fe(jax.random.key(1), j_tiny_config(), vgg_spec=J_TINY)), cfg, TINY_SPEC)

    def init_random():
        from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
        from mmbidaf_tpu_torch.serving import Summarizer

        Summarizer.init_random(cfg, vgg_spec=TINY_SPEC)

    def frontend_init():
        from mmbidaf_tpu_torch.data.frontend import frontend_init as f
        from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC

        f(cfg, TINY_SPEC)

    def audio_consts():
        from mmbidaf_tpu_torch.ops.audio import make_audio_frontend_consts

        make_audio_frontend_consts(16000, 64, 48, 12, 8)

    def model_from_jax():
        from mmbidaf_tpu_torch.interop.from_jax import model_from_jax as f

        f(jax_params(), cfg)

    def cli():
        from mmbidaf_tpu_torch.train import cli as c

        c.main(["--num_steps", "1"])

    def from_run():
        import json
        import tempfile

        from mmbidaf_tpu_torch.data.vocab import save_vocab
        from mmbidaf_tpu_torch.serving import Summarizer

        with tempfile.TemporaryDirectory() as run:
            with open(f"{run}/config.json", "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
            save_vocab({"--PAD--": 0}, wv, f"{run}/vocab.json", f"{run}/emb.npz")
            Summarizer.from_run(run)

    def infer():
        from mmbidaf_tpu_torch import infer as i

        i.main(["--config_json", str(REPO / "examples" / "tiny_config.json")])

    def serve():
        import json
        import tempfile

        from mmbidaf_tpu_torch.data.vocab import save_vocab
        from mmbidaf_tpu_torch.tools import serve as s

        with tempfile.TemporaryDirectory() as run:
            with open(f"{run}/config.json", "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
            save_vocab({"--PAD--": 0}, wv, f"{run}/vocab.json", f"{run}/emb.npz")
            s.main(["--run_dir", run])

    def load_test():
        from mmbidaf_tpu_torch.tools import load_test as lt

        lt.main(["--tiny"])

    return {
        "mmbidaf_init": lambda: mmbidaf_init(cfg, wv),
        "frontend_init": frontend_init,
        "make_audio_frontend_consts": audio_consts,
        "model_from_jax": model_from_jax,
        "frontend_from_jax": frontend_from_jax,
        "train_state_from_jax": lambda: train_state_from_jax(jax_params(), jax_params(), cfg),
        "Summarizer.init_random": init_random,
        "Summarizer.from_jax_params": summarizer_from_jax,
        "train.cli": cli,
        "Summarizer.from_run": from_run,
        "infer": infer,
        "tools.serve": serve,
        "tools.load_test": load_test,
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Called without a device, every entry point asks for the card, and
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
