"""The port takes every shape the JAX kernels take: K5/K6 past the cluster
plan's edge on their L2 route, K4/K3 past win + bins = 1,815 with the frames
a block chosen at launch, and the widths those open (a hidden-512 model, a
4096-point window), held against the JAX package on the CPU.

- ``train_route`` / ``l2_rows`` (``ops/cuda/lstm_kernel.py``, the mirrors of
  ``csrc/lstm_cluster.cuh``): every width to 9,685 has a route, every shape
  the cluster plan takes keeps it, the L2 block fits.
- ``fft_plan`` / ``dense_frames`` / the DCT pass (``ops/cuda/melspec_kernel.py``,
  the mirrors of ``csrc/mfcc.cu``): a block is chosen and fits at every
  n_fft from 16 to 16384 and at windows that are no power of two; the FFT
  route's shapes of the configurations keep 8 frames a block.
- The plain versions against the JAX kernels in interpret mode: the
  trainable BiLSTM at H = 512 (outputs and gradients), an H = 512 model's
  weights through ``interop.from_jax`` (greedy picks), and the log-mel / MFCC
  at n_fft 4096.

The CUDA bodies of these routes run only on the card (``chip_smoke.py``
phase 16, ``tests/test_torch_cuda.py -k "l2 or window"``).

Tolerances: the trainable BiLSTM as ``test_torch_train.py`` holds it at
H = 8 (outputs 2e-5, gradients ``atol=5e-5, rtol=1e-4``): the same f32
steps, with sums over 512 units in XLA's order and PyTorch's. The H = 512
model's log-probs ``atol=1e-5, rtol=1e-5`` as ``test_torch_slice.py``. The
n_fft 4096 spectra: the log-mel elementwise ``atol=2e-5, rtol=1e-5``, the raw
mel within 1e-5 of its largest value, as ``test_torch_long.py``; the MFCC
within ``melspec_kernel.TOLERANCE``: both sides sum 4096-term DFT products
in f32 in different orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
from mmbidaf_tpu.models.mmbidaf import mmbidaf_decode as j_decode
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu.ops import audio as j_audio
from mmbidaf_tpu.ops.lstm import bilstm_init
from mmbidaf_tpu.ops.pallas import melspec_kernel as j_melspec
from mmbidaf_tpu.ops.pallas.lstm_kernel import bilstm_pallas_trainable
from mmbidaf_tpu_torch.interop.from_jax import flatten_pytree, load_pytree, model_from_jax
from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode
from mmbidaf_tpu_torch.ops import audio as t_audio
from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk
from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

SMEM_LIMIT = build.SMEM_LIMIT_BYTES
GRAD_TOL = {"atol": 5e-5, "rtol": 1e-4}

# ---------------------------------------------------------------------------
# K5 / K6: the route of every width.
# ---------------------------------------------------------------------------

ROUTE_H = (8, 100, 128, 384, 400, 448, 512, 699, 700, 1024)
ROUTE_ROWS = (1, 32, 128, 512, 2048)


def _has_cluster_plan(rows: int, H: int) -> bool:
    try:
        lk.cluster_plan(rows, H)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("rows", ROUTE_ROWS)
@pytest.mark.parametrize("H", ROUTE_H)
def test_every_width_has_a_training_route(H, rows):
    """A route for K5 and K6 (K1's rule): the cluster wherever the plan holds,
    else the L2 route, whose block of ``l2_rows`` rows fits a block's shared
    memory."""
    route = lk.train_route(rows, H)
    assert route == lk.serving_route(rows, H)
    if _has_cluster_plan(rows, H):
        assert route == "cluster"
        plan = lk.cluster_plan(rows, H)
        assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_LIMIT
    else:
        assert route == "l2"
        R = lk.l2_rows(rows, H)
        assert R in (1, 2, 4, 8, 16) and lk.l2_smem(H, R) <= SMEM_LIMIT
        assert R == 1 or lk.l2_smem(H, 2 * R) > SMEM_LIMIT or R == (16 if rows >= 1024 else 4)


# Which (H, rows) take the cluster route: the plan's edge at 448, 432 and
# 384 units for 4, 8 and 16 rows a cluster.
SCAN = {
    100: "cccc", 128: "cccc", 256: "cccc", 384: "cccc",
    400: "ccll", 448: "clll", 512: "llll", 768: "llll", 1024: "llll",
}


@pytest.mark.parametrize("H", sorted(SCAN))
def test_the_routes_of_the_width_scan(H):
    """At 32, 128, 512 and 2048 rows: the cluster route to the plan's edge,
    the L2 route past it (the widths where K5 and K6 had no route before
    the L2 route)."""
    got = "".join(lk.train_route(rows, H)[0] for rows in (32, 128, 512, 2048))
    assert got == SCAN[H]


def test_l2_rows_by_waves_then_by_shared_memory():
    """16 rows a block from 1024 rows, else 4; halved while the block's 6H
    floats a row do not fit: 8 past H = 605 at 1024 rows, 1 to H = 9,685,
    and no route past it."""
    assert lk.l2_rows(1024, 512) == 16 and lk.l2_rows(1023, 512) == 4
    assert lk.l2_rows(2048, 605) == 16 and lk.l2_rows(2048, 606) == 8
    assert lk.l2_rows(32, 2421) == 4 and lk.l2_rows(32, 2422) == 2
    assert lk.l2_rows(1, 9685) == 1 and lk.l2_rows(1, 9686) == 0
    assert lk.l2_rows(0, 128) == 0 and lk.l2_rows(4, 0) == 0
    with pytest.raises(ValueError, match="no BiLSTM route"):
        lk.train_route(32, 9686)


def test_the_bench_widths_keep_the_cluster_route():
    """The shapes the cluster route took stay on it: every training tower
    of the bench (H = 128) and capability configurations."""
    for rows in (32 * 32, 32 * 64, 32, 16, 5):
        assert lk.train_route(rows, 128) == "cluster"
    assert all(lk.train_route(rows, H) == "cluster"
               for H in range(1, 385) for rows in (1, 5, 32, 128, 512, 1030))


# K6's walk (``bptt_route``) over the width scan at 32, 128, 512 and 2048
# rows: K5's route, but the grid walk at 32 rows past the cluster plan while
# a block's slice of W_h holds (H to 768).
BPTT_SCAN = {
    100: "cccc", 128: "cccc", 256: "cccc", 384: "cccc",
    400: "ccll", 448: "clll", 512: "glll", 768: "glll", 1024: "llll",
}


@pytest.mark.parametrize("H", sorted(BPTT_SCAN))
def test_the_bptt_routes_of_the_width_scan(H):
    """Every (rows, H) of the scan keeps a route; the grid walk takes only
    shapes K5 serves on its L2 route, and never the cluster route's."""
    got = "".join(lk.bptt_route(rows, H)[0] for rows in (32, 128, 512, 2048))
    assert got == BPTT_SCAN[H]
    for rows in ROUTE_ROWS:
        k5, k6 = lk.train_route(rows, H), lk.bptt_route(rows, H)
        assert k6 == k5 or (k5, k6) == ("l2", "grid")


def test_bptt_route_at_the_bench_shapes():
    """The hidden-512 training towers: the four 32-row towers take the grid
    walk, the 1024-row word tower keeps the L2 walk; hidden 128 keeps its
    clusters."""
    assert lk.bptt_route(32, 512) == "grid"
    assert lk.bptt_route(1024, 512) == "l2"
    assert lk.bptt_route(32, 128) == "cluster"
    assert lk.bptt_route(64, 512) == "grid" and lk.bptt_route(65, 512) == "l2"
    assert lk.bptt_route(32, 769) == "l2"  # 13 units a block
    with pytest.raises(ValueError, match="no BiLSTM route"):
        lk.bptt_route(32, 9686)


@pytest.mark.parametrize("rows,H,P", [(32, 512, 64), (32, 512, 56), (1, 512, 64), (64, 512, 56),
                                      (7, 452, 56), (32, 700, 64), (64, 640, 64), (5, 768, 64)])
def test_grid_plan_covers_the_width(rows, H, P):
    """The grid walk's plan (``lstm_cluster.cuh::grid_plan``) at the shape
    rule's 64 blocks a direction and at the 56 a card with 15 clusters of 8
    runs: unit slices and the cluster's output chunks each cover H once, a
    slice fits the instance's units, threads hold two rows of W_h each and
    at most two (unit, row) pairs, one block an SM, the exchange sized."""
    g = lk.grid_plan(rows, H, P)
    assert (g.P, g.CS, g.NQ) == (P, 8, P // 8)
    for spans, n in ((g.slices, g.P), (g.chunks, g.CS)):
        assert len(spans) == n and spans[0][0] == 0 and spans[-1][1] == H
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:]))
    assert max(e - b for b, e in g.slices) == g.U <= g.UT and g.UT in (8, 10, 12)
    assert g.KC == max(e - b for b, e in g.chunks)
    assert 2 * g.threads >= H and g.threads <= 32 * g.UT and g.UT * g.Rp <= 2 * g.threads
    assert g.Rp % 8 == 0 and rows <= g.Rp < rows + 8
    assert SMEM_LIMIT // 2 < g.smem <= SMEM_LIMIT
    assert g.work == 2 * 2 * g.NQ * H * g.Rp * 2  # parities, directions, 8-byte words


def _grid_walk(gates, mask, w_h, h_seq, c_seq, dout, dh_last, dc_last, g):
    """The grid walk's arithmetic in the kernel's decomposition: each block's
    partial dz[:, its gate columns]·W_h[:, those columns]ᵀ, summed over a
    cluster's ranks in rank order, then over the clusters in order, and added
    to the carried (1-m)·dh."""
    B, T, _ = gates.shape
    H = w_h.shape[1]
    dgates = torch.zeros_like(gates)
    for d in (0, 1):
        dh, dc = dh_last[:, d * H:(d + 1) * H].clone(), dc_last[:, d * H:(d + 1) * H].clone()
        for s in range(T - 1, -1, -1):
            tt = T - 1 - s if d else s
            h_prev = h_seq[d, s - 1] if s > 0 else gates.new_zeros(B, H)
            c_prev = c_seq[d, s - 1] if s > 0 else gates.new_zeros(B, H)
            z = gates[:, tt, d * 4 * H:(d + 1) * 4 * H] + h_prev @ w_h[d]
            i, f, gg, o = z.chunk(4, dim=-1)
            i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
            tanh_c = torch.tanh(f * c_prev + i * gg)
            m = mask[:, tt, None]
            dh_new = m * (dout[:, tt, d * H:(d + 1) * H] + dh)
            dc_new = dh_new * o * (1.0 - tanh_c * tanh_c) + m * dc
            dz = torch.cat([dc_new * gg * i * (1.0 - i), dc_new * c_prev * f * (1.0 - f),
                            dc_new * i * (1.0 - gg * gg), dh_new * tanh_c * o * (1.0 - o)], dim=-1)
            dgates[:, tt, d * 4 * H:(d + 1) * 4 * H] = dz
            total = torch.zeros(B, H)
            for q in range(g.NQ):
                cluster = torch.zeros(B, H)
                for rank in range(g.CS):
                    u0, u1 = g.slices[q * g.CS + rank]
                    cols = torch.cat([torch.arange(u0, u1) + k * H for k in range(4)])
                    cluster = cluster + dz[:, cols] @ w_h[d][:, cols].T
                total = total + cluster
            dh = (1.0 - m) * dh + total
            dc = f * dc_new + (1.0 - m) * dc
    return dgates


@pytest.mark.parametrize("rows,H,P,T", [(5, 452, 56, 6), (3, 512, 64, 4)])
def test_grid_walk_decomposition_matches_the_plain_version(rows, H, P, T):
    """The grid walk's split of dz·W_hᵀ over the plan's slices, ranks and
    clusters gives the plain version's dgates (a ragged mask with an empty
    row, nonzero dh_last / dc_last)."""
    gen = torch.Generator().manual_seed(26)
    gates = torch.randn(rows, T, 8 * H, generator=gen)
    w_h = 0.05 * torch.randn(2, H, 4 * H, generator=gen)
    mask = torch.ones(rows, T)
    mask[1] = 0.0
    mask[2, T // 2:] = 0.0
    _, _, _, h_seq, c_seq = lk.bilstm_train_forward_reference(gates, mask, w_h)
    cot = [torch.randn(*shape, generator=gen)
           for shape in ((rows, T, 2 * H), (rows, 2 * H), (rows, 2 * H))]
    args = (gates, mask, w_h, h_seq, c_seq, *cot)
    ref, _ = lk.bilstm_bptt_reference(*args)
    got = _grid_walk(*args, lk.grid_plan(rows, H, P))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert not got[1].any()


def test_the_grid_walk_is_counted_as_k6():
    """The grid walk's CUDA symbol (read from ``csrc/lstm_bwd.cu``) is one
    of K6's names in the benchmark's kernel table, so ``lstm_roofline.train``
    counts its time against K6's bound; K1 and K5 do not claim it."""
    import importlib.util
    import re
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("pbench_counts", repo / "port_bench" / "pbench" / "counts.py")
    counts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(counts)
    src = (build.CSRC / "lstm_bwd.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(", src)
    grid = [n for n in names if "grid" in n]
    assert grid == ["bilstm_bptt_cluster_kernel_grid"]
    for ut in (8, 10, 12):
        symbol = f"void (anonymous namespace)::{grid[0]}<{ut}>(float const*, float const*)"
        assert counts.is_kernel(symbol, "K6")
        assert not counts.is_kernel(symbol, "K1") and not counts.is_kernel(symbol, "K5")


# ---------------------------------------------------------------------------
# K4 / K3: a block at every window.
# ---------------------------------------------------------------------------

NFFTS = tuple(2 ** k for k in range(4, 15))  # 16 … 16384
ODD_WINDOWS = (400, 1000, 1500, 3000, 6000)


@pytest.mark.parametrize("n_fft", NFFTS)
def test_a_block_at_every_power_of_two(n_fft):
    """win = n_fft (and 400 under 512), 64 or 512 mels, frames that overlap
    (hop 160) or not: K4's and K3's routes, each with a block that fits."""
    bins = n_fft // 2 + 1
    for win in {n_fft, min(n_fft, 400)}:
        for n_mels in (64, 512):
            nnz = 2 * bins
            for ld in (160, win):
                for f64, route in ((False, mk.log_mel_route(win, bins)),
                                   (True, mk.mfcc_route(win, bins))):
                    if route == "fft":
                        plan = mk.fft_plan(n_fft, win, ld, n_mels, nnz, f64)
                        assert plan is not None and plan.frames in (1, 2, 4, 8)
                        span_ld = ld if ld <= win else win  # frames apart: one by one
                        assert plan.smem == mk.fft_smem_bytes(n_fft, win, span_ld, n_mels,
                                                              plan.staged, f64,
                                                              plan.frames) <= SMEM_LIMIT
                    else:
                        F = mk.dense_frames(win, bins)
                        assert F in (1, 2, 4, 8, 16, 32)
                        assert mk.dense_smem_bytes(win, bins, F) <= SMEM_LIMIT
                        assert F == 32 or mk.dense_smem_bytes(win, bins, 2 * F) > SMEM_LIMIT
    assert mk.log_mel_route(n_fft, bins) == ("fft" if n_fft <= 8192 else "dense")
    assert mk.mfcc_route(n_fft, bins) == ("fft" if n_fft <= 4096 else "dense")


@pytest.mark.parametrize("win", ODD_WINDOWS)
def test_windows_that_are_no_power_of_two_take_the_dense_route(win):
    """n_fft = win: the dense route at the most frames a block that fit
    (32 to win + bins = 1,815, 16 at 1,500, 8 at 3,000, 4 at 6,000)."""
    bins = win // 2 + 1
    assert mk.log_mel_route(win, bins) == mk.mfcc_route(win, bins) == "dense"
    F = mk.dense_frames(win, bins)
    assert F == {400: 32, 1000: 32, 1500: 16, 3000: 8, 6000: 4}[win]
    assert mk.dense_smem_bytes(win, bins, F) <= SMEM_LIMIT < mk.dense_smem_bytes(win, bins, 2 * F) \
        or F == 32


def test_the_dense_route_ends_where_one_frame_no_longer_fits():
    assert mk.dense_frames(1000, 815) == 32 and mk.dense_frames(1000, 816) == 16
    assert mk.dense_frames(32768, 16385) == 1  # n_fft 32,768
    assert mk.dense_frames(40000, 20000) == 0


def test_the_fft_route_keeps_its_blocks_at_the_configurations():
    """The configurations' shapes (n_fft 64 and 512, 64 mels, hop 16 / 160)
    keep 8 frames a block and their staged weights; 4096 takes 4 (K4) and 2
    (K3's f64), 8192 two and has no K3 block."""
    for n_fft, win, hop, n_mels in ((64, 48, 16, 12), (512, 400, 160, 64), (1024, 1024, 160, 80)):
        nnz = mk.mel_nonzeros(t_audio.make_audio_frontend_consts(
            16000, n_fft, win, n_mels, 8, device="cpu")["mel_fb"])[1].numel()
        for f64 in (False, True):
            plan = mk.fft_plan(n_fft, win, hop, n_mels, nnz, f64)
            assert plan.frames == mk.FFT_FRAMES and plan.staged == nnz
    assert mk.fft_plan(4096, 4096, 160, 64, 4098).frames == 4
    assert mk.fft_plan(4096, 4096, 160, 64, 4098, f64=True).frames == 2
    assert mk.fft_plan(8192, 8192, 160, 64, 8194).frames == 2
    assert mk.fft_plan(8192, 8192, 160, 64, 8194, f64=True) is None
    assert mk.fft_plan(16384, 16384, 160, 64, 16386) is None


@pytest.mark.parametrize("n_mels", [64, 384, 385, 512, 1815])
def test_the_dct_pass_takes_up_to_1815_mels(n_mels):
    assert mk.dct_smem_bytes(n_mels) + 4 <= SMEM_LIMIT
    assert (mk.dct_smem_bytes(n_mels) > 48 * 1024) == (n_mels > 384)


def test_the_dct_pass_refuses_past_1815_mels():
    assert mk.dct_smem_bytes(1816) + 4 > SMEM_LIMIT


# ---------------------------------------------------------------------------
# The plain versions against the JAX kernels at the new widths.
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_trainable_bilstm_at_hidden_512_matches_pallas():
    """K5/K6's plain versions (the wrapper on CPU tensors) against
    ``bilstm_pallas_trainable`` in interpret mode at H = 512, B = 8, T = 4:
    a masked row, cotangents on the final h and c."""
    rng = np.random.default_rng(20)
    B, T, D, h = 8, 4, 16, 512
    jp = bilstm_init(jax.random.key(20), D, h)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([4, 3, 0, 4, 1, 2, 4, 3])[:, None]).astype(np.float32)
    w_out = rng.standard_normal((B, T, 2 * h)).astype(np.float32)
    w_h = rng.standard_normal((B, 2 * h)).astype(np.float32)

    def j_loss(p, xx):
        out, (h_n, c_n) = bilstm_pallas_trainable(p, xx, jnp.asarray(mask), interpret=True)
        return (out * w_out).sum() + (h_n * w_h).sum() + (c_n ** 2).sum(), (out, h_n, c_n)

    (j_l, j_outs), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    port = BiLSTMParams(D, h, torch.Generator().manual_seed(0), "cpu")
    load_pytree(port, _np(jp))
    for p in port.parameters():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    assert lk.train_route(B, h) == "l2"  # the card's route for this shape
    out, (h_n, c_n) = lk.bilstm_cuda_trainable(port, xt, torch.from_numpy(mask))
    loss = (out * torch.from_numpy(w_out)).sum() + (h_n * torch.from_numpy(w_h)).sum() \
        + (c_n ** 2).sum()
    loss.backward()
    for o, r in zip((out, h_n, c_n), j_outs):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=2e-5)
    assert not out[2].any() and not h_n[2].any() and not c_n[2].any()
    np.testing.assert_allclose(loss.item(), float(j_l), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_grads[1]), **GRAD_TOL)
    for k, g in flatten_pytree(_np(j_grads[0])).items():
        np.testing.assert_allclose(port.get_parameter(k).grad.numpy(), g, **GRAD_TOL, err_msg=k)


def test_hidden_512_weights_carry_over_with_equal_picks():
    """An H = 512 model (BiDAF width 1024) made by the JAX package, carried by
    ``interop.from_jax``: greedy picks equal, log-probs within 1e-5, the
    port on its kernel wrappers (their plain versions on the CPU)."""
    rng = np.random.default_rng(21)
    j_cfg = j_tiny_config()
    j_cfg = dataclasses.replace(j_cfg, model=dataclasses.replace(j_cfg.model, hidden_size=512))
    from mmbidaf_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, hidden_size=512, use_pallas_lstm=True, use_pallas_attention=True))
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(21), j_cfg, jnp.asarray(wv))
    batch = synthetic_batch(rng, j_cfg, batch_size=2)
    batch.pop("targets"), batch.pop("target_mask")
    j_lp, j_picks = j_decode(params, {k: jnp.asarray(v) for k, v in batch.items()}, j_cfg)
    model = model_from_jax(_np(params), cfg, device="cpu")
    with torch.inference_mode():
        lp, picks = mmbidaf_decode(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5, rtol=1e-5)


N_FFT, HOP = 4096, 160


def _frames_4096(rng, B, T):
    sig = (rng.standard_normal((B, (T - 1) * HOP + N_FFT)) * 0.1).astype(np.float32)
    sig[1] = 0.0  # a silent example
    return sig


@pytest.fixture(scope="module")
def consts_4096():
    consts = t_audio.make_audio_frontend_consts(16000, N_FFT, N_FFT, 64, 40, device="cpu")
    return consts, {k: jnp.asarray(v.numpy()) for k, v in consts.items()}


@pytest.mark.parametrize("log", [True, False], ids=["log", "raw_mel"])
def test_log_mel_at_n_fft_4096_matches_pallas(consts_4096, log):
    """K4's plain version against ``log_mel_fused`` in interpret mode at
    n_fft = win = 4096 (a few frames, a silent example)."""
    consts, j_consts = consts_4096
    rng = np.random.default_rng(22)
    T = 5
    sig = _frames_4096(rng, 3, T)
    frames = t_audio.frame_signal(torch.from_numpy(sig), N_FFT, HOP, T)
    assert mk.log_mel_route(N_FFT, N_FFT // 2 + 1) == "fft"
    ours = mk.log_mel_fused(frames, consts, log=log).numpy()
    ref = np.asarray(j_melspec.log_mel_fused(
        j_audio.frame_signal(jnp.asarray(sig), N_FFT, HOP, T), j_consts, tile_n=8,
        interpret=True, log=log))
    assert ours.shape == (3, T, 64)
    if log:
        np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(ours, ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-5)


def test_mfcc_at_n_fft_4096_matches_pallas(consts_4096):
    """K3's plain version against ``mfcc_fused`` in interpret mode at n_fft =
    win = 4096: the silent example exactly 0."""
    consts, j_consts = consts_4096
    rng = np.random.default_rng(23)
    T = 6
    sig = _frames_4096(rng, 2, T)
    frames = t_audio.frame_signal(torch.from_numpy(sig), N_FFT, HOP, T)
    assert mk.mfcc_fused_fits(T, N_FFT, N_FFT // 2 + 1, 64)
    assert mk.mfcc_route(N_FFT, N_FFT // 2 + 1) == "fft"
    ours = mk.mfcc_fused(frames, consts).numpy()
    ref = np.asarray(j_melspec.mfcc_fused(j_audio.frame_signal(jnp.asarray(sig), N_FFT, HOP, T),
                                          j_consts, interpret=True))
    assert ours.shape == (2, T, 40) and not ours[1].any()
    np.testing.assert_allclose(ours, ref, **mk.TOLERANCE)
