"""The port's top-k and beam decoding against the JAX package, on the CPU.

Beam search is deterministic and must equal ``decoder_beam_search``: picks
equal, the sequence log-prob within ``atol=1e-5`` (f32, sums in XLA's and
PyTorch's orders), ties broken as ``jax.lax.top_k`` breaks them (a row with
fewer valid sentences than beams ties at step 0). Top-k's draws come from
another generator than JAX's, so the pick rule is held exactly under JAX's
own Gumbel noise, the whole top-k decode under JAX's noise injected step by
step, and the sampling to its distribution (a chi-square test).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config
from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
from mmbidaf_tpu.models.decoder import decoder_apply as j_apply
from mmbidaf_tpu.models.decoder import decoder_beam_search as j_beam
from mmbidaf_tpu.models.decoder import decoder_init as j_decoder_init
from mmbidaf_tpu.models.mmbidaf import mmbidaf_decode as j_decode
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu_torch.interop.from_jax import load_pytree, model_from_jax
from mmbidaf_tpu_torch.models import decoder as port_decoder
from mmbidaf_tpu_torch.models.decoder import (
    Decoder,
    decoder_apply,
    decoder_beam_search,
    topk_pick,
)
from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode
from mmbidaf_tpu_torch.ops.lstm import lstm_cell
from mmbidaf_tpu_torch.ops.masked import mask_logits


def T(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _decoder_setup(seed=0, B=4, T_s=6, d=8, lengths=(6, 2, 4, 1)):
    """JAX decoder params and the port's Decoder holding them, fused reps M
    and a prefix mask with the given lengths."""
    rng = np.random.default_rng(seed)
    params = j_decoder_init(jax.random.key(seed + 2), d, d)
    dec = Decoder(d, d, torch.Generator().manual_seed(0), "cpu")
    load_pytree(dec, _np(params))
    M = rng.standard_normal((B, T_s, d)).astype(np.float32)
    mask = (np.arange(T_s)[None] < np.asarray(lengths)[:B, None]).astype(np.float32)
    return params, dec, M, mask


@pytest.mark.parametrize("beam", [1, 2, 4])
@pytest.mark.parametrize("mask_selected", [True, False])
def test_beam_matches_jax(beam, mask_selected):
    """Rows of 1 and 2 valid sentences under beams of 2 and 4 tie among the
    masked continuations from step 0 on."""
    params, dec, M, mask = _decoder_setup()
    j_lp, j_picks = j_beam(params, jnp.asarray(M), jnp.asarray(mask), num_steps=3,
                           beam_size=beam, mask_selected=mask_selected)
    lp, picks = decoder_beam_search(dec, T(M), T(mask), num_steps=3, beam_size=beam,
                                    mask_selected=mask_selected)
    assert picks.dtype == torch.int32 and picks.shape == (4, 3) and lp.shape == (4,)
    np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5, rtol=0)


def _seq_score(dec, M_b, mask_b, picks, mask_selected=True):
    """The port's re-score of one example's pick sequence, step by step."""
    d = M_b.shape[-1]
    h = c = torch.zeros(1, d)
    inp = dec.start[None]
    selected = torch.zeros(1, M_b.shape[0])
    total = 0.0
    with torch.no_grad():
        for p in picks:
            h, c = lstm_cell(inp @ dec.lstm.w_x + dec.lstm.b, h, c, dec.lstm.w_h)
            att = torch.tanh(M_b[None] @ dec.w_m + (h @ dec.w_d)[:, None, :]) @ dec.v
            avail = mask_b[None] * (1.0 - selected) if mask_selected else mask_b[None]
            log_p = torch.log_softmax(mask_logits(att, avail), dim=-1)
            total += float(log_p[0, p])
            selected[0, p] = 1.0
            inp = M_b[p][None]
    return total


def test_beam_size_one_equals_greedy():
    _, dec, M, mask = _decoder_setup(lengths=(6, 3, 4, 5))
    with torch.no_grad():
        _, greedy = decoder_apply(dec, T(M), T(mask), num_steps=3)
        _, beam = decoder_beam_search(dec, T(M), T(mask), num_steps=3, beam_size=1)
    np.testing.assert_array_equal(beam.numpy(), greedy.numpy())


def test_beam_score_consistent_and_beats_greedy():
    _, dec, M, mask = _decoder_setup(seed=3, lengths=(6, 3, 4, 5))
    M, mask = T(M), T(mask)
    with torch.no_grad():
        scores, picks = decoder_beam_search(dec, M, mask, num_steps=3, beam_size=4)
        _, greedy = decoder_apply(dec, M, mask, num_steps=3)
    for b in range(M.shape[0]):
        rescore = _seq_score(dec, M[b], mask[b], picks[b].tolist())
        np.testing.assert_allclose(float(scores[b]), rescore, rtol=1e-4, atol=1e-4)
        assert float(scores[b]) >= _seq_score(dec, M[b], mask[b], greedy[b].tolist()) - 1e-5


def test_wide_beam_equals_exhaustive():
    _, dec, M, mask = _decoder_setup(seed=5, B=2, T_s=4, lengths=(4, 3))
    M, mask = T(M), T(mask)
    K = 2
    with torch.no_grad():
        scores, picks = decoder_beam_search(dec, M, mask, num_steps=K, beam_size=16)
    for b in range(2):
        n_valid = int(mask[b].sum())
        best, best_seq = -np.inf, None
        for seq in itertools.product(range(n_valid), repeat=K):
            if len(set(seq)) < K:  # mask_selected forbids repeats
                continue
            s = _seq_score(dec, M[b], mask[b], list(seq))
            if s > best:
                best, best_seq = s, seq
        np.testing.assert_allclose(float(scores[b]), best, rtol=1e-4, atol=1e-4)
        assert tuple(picks[b].tolist()) == best_seq


def _log_p_rows():
    """Log-probs with a tie at the k-th value (row 1), a masked tail (row 2)
    and distinct values (row 0)."""
    p = np.array([[0.05, 0.3, 0.1, 0.25, 0.2, 0.1],
                  [0.2, 0.2, 0.2, 0.2, 0.1, 0.1],
                  [0.4, 0.35, 0.25, 0.0, 0.0, 0.0]])
    return np.where(p > 0, np.log(np.maximum(p, 1e-30)), -1e30).astype(np.float32)


@pytest.mark.parametrize("topk", [1, 2, 3, 6])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_topk_pick_rule_matches_categorical(topk, seed):
    """Under JAX's own noise, ``topk_pick`` picks what
    ``jax.random.categorical`` picks from the truncated log-probs."""
    log_p = _log_p_rows()
    key = jax.random.key(seed)
    g = np.asarray(jax.random.gumbel(key, log_p.shape))
    lp = jnp.asarray(log_p)
    trunc = jnp.where(lp >= jnp.sort(lp, axis=-1)[:, -topk][:, None], lp, -jnp.inf)
    want = np.asarray(jax.random.categorical(key, trunc))
    np.testing.assert_array_equal(topk_pick(T(log_p), topk, T(g)).numpy(), want)


def test_topk_pick_keeps_ties_at_kth():
    """Row 1 has four sentences tied at the 2nd value: all four stay in the
    set (noise favouring each in turn picks it)."""
    log_p = T(_log_p_rows())[1:2]
    for j in range(4):
        g = torch.zeros(1, 6)
        g[0, j] = 1.0
        assert int(topk_pick(log_p, 2, g)) == j
    g = torch.zeros(1, 6)
    g[0, 4] = 50.0  # outside the set: no noise brings it back
    assert int(topk_pick(log_p, 2, g)) in range(4)


def _jax_step_noise(key, num_steps, shape):
    """The Gumbel noise ``jax.random.categorical`` adds at each decode step
    of ``decoder_apply(mode="topk", rng=key)``."""
    return [np.asarray(jax.random.gumbel(k, shape)) for k in jax.random.split(key, num_steps)]


@pytest.mark.parametrize("topk", [2, 3])
def test_topk_decode_matches_jax_under_its_noise(monkeypatch, topk):
    """The whole top-k decode with JAX's per-step noise injected: picks equal
    and log-probs within 1e-5 of ``decoder_apply(mode="topk")``."""
    params, dec, M, mask = _decoder_setup(seed=7, lengths=(6, 3, 4, 5))
    key = jax.random.key(11)
    j_lp, j_picks = j_apply(params, jnp.asarray(M), jnp.asarray(mask), num_steps=4,
                            mode="topk", topk=topk, rng=key)
    noise = iter(_jax_step_noise(key, 4, mask.shape))
    monkeypatch.setattr(port_decoder, "gumbel_noise", lambda shape, gen, dtype: T(next(noise)))
    with torch.no_grad():
        lp, picks = decoder_apply(dec, T(M), T(mask), num_steps=4, mode="topk", topk=topk,
                                  generator=torch.Generator())
    np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5, rtol=1e-5)


def test_topk_needs_a_generator():
    _, dec, M, mask = _decoder_setup()
    with pytest.raises(ValueError, match="Generator"):
        decoder_apply(dec, T(M), T(mask), mode="topk")
    with pytest.raises(ValueError, match="unknown decode mode"):
        decoder_apply(dec, T(M), T(mask), mode="sample")


def test_topk_samples_the_renormalised_topk_distribution():
    """3000 draws of one row from a seeded generator: every pick inside the
    top-3 set, frequencies matching the renormalised top-3 probabilities
    (chi-square, 2 degrees of freedom, p > 0.001); the same seed gives the
    same picks."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal(8).astype(np.float32) * 1.5
    log_p = torch.log_softmax(T(logits), dim=-1)
    n, k = 3000, 3
    rows = log_p.expand(n, 8)
    gen = torch.Generator().manual_seed(9)
    picks = topk_pick(rows, k, port_decoder.gumbel_noise((n, 8), gen, torch.float32)).numpy()
    top = np.argsort(-log_p.numpy())[:k]
    assert set(picks.tolist()) <= set(top.tolist())
    probs = np.exp(log_p.numpy()[top])
    probs /= probs.sum()
    counts = np.array([(picks == t).sum() for t in top])
    chi2 = float(((counts - n * probs) ** 2 / (n * probs)).sum())
    assert chi2 < 13.82, (counts, n * probs)  # chi-square(2) at p = 0.001
    gen2 = torch.Generator().manual_seed(9)
    again = topk_pick(rows, k, port_decoder.gumbel_noise((n, 8), gen2, torch.float32)).numpy()
    np.testing.assert_array_equal(again, picks)


def _model_setup(seed=0, B=3):
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc))
    rng = np.random.default_rng(seed)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(seed), cfg, jnp.asarray(wv))
    batch = synthetic_batch(rng, cfg, batch_size=B)
    batch.pop("targets"), batch.pop("target_mask")
    batch["sent_mask"][1, 2:] = 0.0  # two valid sentences under a beam of 4
    batch["word_mask"][1, 2:] = 0.0
    return cfg, params, batch


@pytest.mark.parametrize("beam", [1, 4])
def test_mmbidaf_decode_beam_matches_jax(beam):
    cfg, params, batch = _model_setup()
    j_lp, j_picks = j_decode(params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg,
                             mode="beam", topk=beam)
    with torch.inference_mode():
        lp, picks = mmbidaf_decode(model_from_jax(_np(params), cfg, device="cpu"),
                                   {k: T(v) for k, v in batch.items()}, cfg, mode="beam", topk=beam)
    assert lp.shape == (3,)  # the best beam's total, in the place of per-step log-probs
    np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5, rtol=0)


def test_mmbidaf_decode_topk_valid_and_reproducible():
    cfg, params, batch = _model_setup(seed=1)
    model = model_from_jax(_np(params), cfg, device="cpu")
    tb = {k: T(v) for k, v in batch.items()}
    with torch.inference_mode():
        lp, picks = mmbidaf_decode(model, tb, cfg, mode="topk", topk=3,
                                   generator=torch.Generator().manual_seed(5))
        _, again = mmbidaf_decode(model, tb, cfg, mode="topk", topk=3,
                                  generator=torch.Generator().manual_seed(5))
        _, greedy = mmbidaf_decode(model, tb, cfg)
    np.testing.assert_array_equal(picks.numpy(), again.numpy())
    K = cfg.model.max_decode_steps
    for b in range(3):
        row = picks[b].tolist()
        n_valid = min(int(batch["sent_mask"][b].sum()), K)
        # valid and distinct while valid sentences remain (then all are masked)
        assert all(batch["sent_mask"][b, p] == 1 for p in row[:n_valid])
        assert len(set(row[:n_valid])) == n_valid
        for k in range(K):  # each pick inside that step's top-3 set
            kth = torch.sort(lp[b, k]).values[-3]
            assert lp[b, k, row[k]] >= kth
    # step 0's log-probs do not depend on the sampling
    np.testing.assert_allclose(lp[:, 0].numpy(), mmbidaf_decode(model, tb, cfg)[0][:, 0].numpy())
    assert greedy.shape == picks.shape
