"""The port's VGG frontend under ``use_winograd_conv`` and the kernels K10-K14
on the CPU, against the JAX package with the same numpy-seeded inputs and
weights (``interop/from_jax.py``); the Pallas kernels run in interpret mode,
as ``tests/test_pallas_kernels.py`` runs them. On a CPU tensor each kernel
wrapper runs its plain version (the CUDA kernels are held against those on
the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``).

Tolerances. f32 on both sides with sums in different orders (XLA's vs
PyTorch's): ``atol=2e-5`` on conv outputs of O(1), as the JAX package holds
its own Winograd and conv kernels against ``lax.conv``. bf16 outputs are
roundings of f32 values that agree to ~1e-6, so they can land one bf16 ulp
apart: ``rtol=2**-7`` (an ulp is at most 2⁻⁷ of the value). The preprocess
kernel's resize weights come from ``jax.image.resize`` on the JAX side and
from the port's numpy ``resize_matrix`` (they differ by up to 7e-6), so
``atol=1e-4`` as the JAX package's own test; K10's banded resize, emulated
in numpy, sums the same f32 products as the plain version in another
order: ``atol=1e-5`` on values up to 2.7. ``F.interpolate``'s antialiased
weights, the library call timed beside K10, agree with ``resize_matrix`` to
1.2e-7 at 240 -> 224: ``atol=1e-6``. End to end in f32: picks equal,
log-probs within 1e-4.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config
from mmbidaf_tpu.ops import vgg as j_vgg
from mmbidaf_tpu.ops.winograd import winograd_conv3x3 as j_winograd
from mmbidaf_tpu_torch.interop.from_jax import load_pytree
from mmbidaf_tpu_torch.ops import vgg as t_vgg
from mmbidaf_tpu_torch.ops import winograd as t_winograd
from mmbidaf_tpu_torch.ops.cuda import (build, conv_epilogue_kernel, conv_kernel, preprocess_kernel,
                                        winograd_kernel)

SPEC = (32, 32, "M", 64, "M")  # conv2 and conv3 have C_in >= 32: the Winograd route
BF16_ULP = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.array(x))


def _conv_inputs(rng, N, H, W, Cin, Cout, w_scale=0.2):
    x = rng.standard_normal((N, H, W, Cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, Cin, Cout)) * w_scale).astype(np.float32)
    b = rng.standard_normal(Cout).astype(np.float32)
    return x, w, b


def _lax_conv(x, w, b, relu):
    y = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    return np.asarray(jnp.maximum(y, 0.0) if relu else y)


@pytest.mark.parametrize("N,H,W,Cin,Cout", [(2, 8, 8, 5, 7), (3, 9, 11, 4, 6), (5, 14, 14, 32, 16)])
def test_winograd_conv_matches_jax(rng, N, H, W, Cin, Cout):
    """The port's ``ops/winograd.py`` against JAX's ``winograd_conv3x3``,
    odd H/W included, and against ``lax.conv``."""
    x, w, b = _conv_inputs(rng, N, H, W, Cin, Cout)
    ours = t_winograd.winograd_conv3x3(_t(x), _t(w), _t(b)).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_winograd(jnp.asarray(x), jnp.asarray(w),
                                                           jnp.asarray(b))), atol=2e-5)
    np.testing.assert_allclose(ours, _lax_conv(x, w, b, relu=False), atol=2e-5)


def test_winograd_conv_bf16_matches_jax(rng):
    """bf16: V and U rounded to bf16, products summed in f32 (not a bf16
    matmul that rounds its output), one cast — JAX's numerics."""
    x, w, b = _conv_inputs(rng, 2, 9, 11, 32, 16)
    xb, wb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    ref = np.asarray(j_winograd(xb, wb, bb).astype(jnp.float32))
    ours = t_winograd.winograd_conv3x3(*(_t(a).bfloat16() for a in (x, w, b)))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=BF16_ULP, atol=1e-5)


@pytest.mark.parametrize("N,H,W,Cin,Cout,kblk", [
    (2, 8, 8, 128, 128, 128), (1, 14, 14, 128, 256, 128), (2, 13, 9, 128, 128, 128)])
def test_k14_plain_matches_pallas(rng, N, H, W, Cin, Cout, kblk):
    """K14's wrapper on the CPU (its plain version) against the Pallas
    Winograd kernel in interpret mode, bias and ReLU fused."""
    from mmbidaf_tpu.ops.pallas.winograd_kernel import winograd_conv3x3_fused as j_fused

    x, w, b = _conv_inputs(rng, N, H, W, Cin, Cout, w_scale=0.1)
    before = winograd_kernel.winograd_conv3x3_fused.launches
    ours = winograd_kernel.winograd_conv3x3_fused(_t(x), _t(w), _t(b), relu=True).numpy()
    ref = j_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=True, k_block=kblk,
                  interpret=True)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5)
    assert winograd_kernel.winograd_conv3x3_fused.launches == before  # the plain path is no launch


@pytest.mark.parametrize("name,shape", [
    ("conv3x3_same", (2, 8, 16, 5, 7)), ("conv3x3_same_acc", (2, 8, 16, 5, 7)),
    ("conv3x3_same_db", (2, 12, 16, 5, 7))])
def test_k11_k13_plain_match_pallas(rng, name, shape):
    """K11, K12 and K13's wrappers on the CPU against the three Pallas conv
    kernels in interpret mode (SAME 3x3 + bias + ReLU)."""
    from mmbidaf_tpu.ops.pallas import conv_kernel as j_conv

    x, w, b = _conv_inputs(rng, *shape)
    ours = getattr(conv_kernel, name)(_t(x), _t(w), _t(b)).numpy()
    ref = getattr(j_conv, name)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), tile_h=4,
                                interpret=True)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(ours, _lax_conv(x, w, b, relu=True), atol=2e-5)


@pytest.mark.parametrize("n,h,w,s", [(3, 48, 64, 32), (2, 32, 20, 32)])
def test_k10_plain_matches_pallas(rng, n, h, w, s):
    """K10's wrapper on the CPU against the Pallas preprocess kernel in
    interpret mode: f32, and bf16 (computed in f32, one cast)."""
    from mmbidaf_tpu.ops.pallas.preprocess_kernel import preprocess_frames_fused as j_pre

    x = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    ours = preprocess_kernel.preprocess_frames_fused(_t(x), s, torch.float32)
    ref = j_pre(jnp.asarray(x), s, dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    ours = preprocess_kernel.preprocess_frames_fused(_t(x), s, torch.bfloat16)
    ref = j_pre(jnp.asarray(x), s, dtype=jnp.bfloat16, interpret=True)
    assert ours.dtype == torch.bfloat16 and ours.shape == (n, s, s, 3)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-4)


@pytest.mark.parametrize("dst,src", [(224, 240), (224, 320), (224, 1080), (224, 100), (224, 224)])
def test_band_taps_rebuild_resize_matrix(dst, src):
    """K10's banded weights rebuild the port's resize matrix bit for bit:
    every tap window lies inside [0, src), and T is the widest band (3 for
    a downscale by less than 2x, 2 for an upscale, 1 for the identity)."""
    first, weights = preprocess_kernel.band_taps(dst, src)
    taps = weights.shape[1]
    assert first.dtype == np.int32 and weights.dtype == np.float32 and first.shape == (dst,)
    assert first.min() >= 0 and first.max() + taps <= src
    dense = np.zeros((dst, src), np.float32)
    for s, f in enumerate(first):
        dense[s, f:f + taps] = weights[s]
    assert np.array_equal(dense.view(np.int32), t_vgg.resize_matrix(dst, src).view(np.int32))
    assert taps == {240: 3, 320: 3, 100: 2, 224: 1}.get(src, taps)


def _band_resize(x: np.ndarray, s: int) -> np.ndarray:
    """K10's arithmetic in numpy f32: the H pass over each output row's taps,
    then the W pass over each output column's taps with 1/(255·std_c)
    folded in, each summed over increasing input index, then the bias."""
    _, h, w, _ = x.shape
    first_h, wh = preprocess_kernel.band_taps(s, h)
    first_w, rw = preprocess_kernel.band_taps(s, w)
    scale = (np.float32(1.0) / (np.float32(255.0) * t_vgg.IMAGENET_STD)).astype(np.float32)
    ww = rw[None] * scale[:, None, None]  # [3, S, Tw]
    xf = x.astype(np.float32)
    t = np.zeros((x.shape[0], s, w, 3), np.float32)
    for i in range(wh.shape[1]):
        t += wh[None, :, i, None, None] * xf[:, first_h + i]
    out = np.zeros((x.shape[0], s, s, 3), np.float32)
    for i in range(ww.shape[2]):
        out += t[:, :, first_w + i, :] * ww[:, :, i].T[None, None]
    return out - (t_vgg.IMAGENET_MEAN / t_vgg.IMAGENET_STD).astype(np.float32)


@pytest.mark.parametrize("n,h,w,s", [(2, 48, 64, 32), (2, 20, 30, 33)])
def test_band_resize_matches_plain_and_pallas(rng, n, h, w, s):
    """K10's banded two-pass resize, emulated, against the plain version and
    the Pallas preprocess kernel in interpret mode (a downscale and an
    upscale)."""
    from mmbidaf_tpu.ops.pallas.preprocess_kernel import preprocess_frames_fused as j_pre

    x = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    ours = _band_resize(x, s)
    plain = preprocess_kernel.preprocess_reference(_t(x), s).numpy()
    np.testing.assert_allclose(ours, plain, atol=1e-5)
    ref = j_pre(jnp.asarray(x), s, dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("s,h,w,rows", [(224, 240, 320, 8), (224, 1080, 1920, 2), (33, 20, 30, 8),
                                        (16, 16, 16, 8)])
def test_preprocess_plan_fits(s, h, w, rows):
    """K10's block: 8 output rows at the tool's frames, fewer for 1080p; every
    tile's input rows within ``band_rows``, the block within Hopper's shared
    memory."""
    plan = preprocess_kernel.preprocess_plan(s, h, w)
    assert plan.rows == rows and plan.smem <= build.SMEM_LIMIT_BYTES
    first, wh = preprocess_kernel.band_taps(s, h)
    for s0 in range(0, s, rows):
        tile = first[s0:s0 + rows]
        assert tile.max() + wh.shape[1] - tile.min() <= plan.band_rows
    with pytest.raises(ValueError, match="shared memory"):
        preprocess_kernel.preprocess_plan(224, 240, 40000)


@pytest.mark.parametrize("dst,src", [(224, 240), (224, 320)])
def test_interpolate_antialias_matches_resize_matrix(dst, src):
    """``F.interpolate(..., "bilinear", antialias=True, align_corners=False)``,
    the library call timed beside K10 on the card, resizes with the port's
    weights to 1e-6 (one axis resized, the identity on the other)."""
    eye = torch.eye(src).reshape(1, 1, src, src)
    out = torch.nn.functional.interpolate(eye, size=(dst, src), mode="bilinear", antialias=True,
                                          align_corners=False)[0, 0]
    np.testing.assert_allclose(out.numpy(), t_vgg.resize_matrix(dst, src), atol=1e-6, rtol=0)


def _vgg_pair(spec, image_size=32, fc_dim=64, seed=8):
    jp = j_vgg.vgg_init(jax.random.key(seed), spec, image_size=image_size, fc_dim=fc_dim)
    port = t_vgg.VGG(spec, image_size, fc_dim, 3, torch.Generator().manual_seed(0), "cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["convs"] = [{"w": c["w"].transpose(3, 2, 0, 1), "b": c["b"]} for c in tree["convs"]]
    load_pytree(port, tree)
    return jp, port


def test_vgg_features_winograd_matches_jax(rng):
    """``vgg_features(winograd=True)`` against JAX's, f32: the Winograd convs
    and the direct stem, pools, the NCHW flatten and the fc layers."""
    jp, port = _vgg_pair(SPEC)
    imgs = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    ref = j_vgg.vgg_features(jp, jnp.asarray(imgs), SPEC, winograd=True)
    ours = t_vgg.vgg_features(port, _t(imgs), SPEC, winograd=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def _parent_fc2_partial(params, images, spec, winograd=False):
    """The stack as it ran before the epilogue kernel: NCHW-strided
    activations, each direct conv with its bias inside ``F.conv2d``, then
    ``F.relu`` and ``F.max_pool2d`` passes."""
    F = torch.nn.functional
    x, ci = images.permute(0, 3, 1, 2), 0
    for item in spec:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        conv = params.convs[ci]
        if winograd and conv.w.shape[1] >= 32:
            x = winograd_kernel.winograd_conv3x3_fused(
                x.permute(0, 2, 3, 1).contiguous(), conv.w.permute(2, 3, 1, 0), conv.b,
                relu=True).permute(0, 3, 1, 2)
        else:
            x = F.relu(F.conv2d(x, conv.w.contiguous(), conv.b, padding=1))
        ci += 1
    x = x.reshape(x.shape[0], -1)
    return torch.relu(x @ params.fc1_w + params.fc1_b) @ params.fc2_w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("C", [3, 8, 64])
@pytest.mark.parametrize("H,W", [(6, 8), (7, 5)], ids=["even", "odd"])
@pytest.mark.parametrize("pool", [False, True], ids=["inplace", "pool"])
def test_conv_epilogue_plain_matches_bias_relu_pool(dtype, layout, C, H, W, pool):
    """The epilogue op's plain version on a conv's output: bit for bit the
    separate bias add (rounded once to the dtype), ReLU and ``max_pool2d``
    (floor sizes), and within the dtype's rounding of the conv with its bias
    inside; in place without ``pool`` (the wrapper returns ``y`` itself),
    ``y`` untouched with it; the storage layout kept."""
    F = torch.nn.functional
    g = torch.Generator().manual_seed(C * 100 + H)
    x = torch.randn(3, 4, H, W, generator=g).to(dtype)
    w = (torch.randn(C, 4, 3, 3, generator=g) * 0.3).to(dtype)
    b = torch.randn(C, generator=g).to(dtype)
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    x, w = x.contiguous(memory_format=fmt), w.contiguous(memory_format=fmt)
    y = F.conv2d(x, w, None, padding=1)
    y0 = y.clone()
    want = F.relu(y0 + b.view(-1, 1, 1))
    want = F.max_pool2d(want, 2, 2) if pool else want
    before = conv_epilogue_kernel.conv_epilogue.launches
    got = conv_epilogue_kernel.conv_epilogue(y, b, pool)
    assert conv_epilogue_kernel.conv_epilogue.launches == before  # the CPU runs no kernel
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=fmt)
    if pool:
        assert torch.equal(y, y0)
    else:
        assert got.data_ptr() == y.data_ptr()
    fused = F.relu(F.conv2d(x, w, b, padding=1))
    fused = F.max_pool2d(fused, 2, 2) if pool else fused
    # bf16: the bias-free conv's output was rounded once more, by at most
    # half an ulp (2^-8 of its largest value)
    tol = {} if dtype == torch.float32 else {"atol": float(y0.abs().max()) * 2.0 ** -8,
                                             "rtol": BF16_ULP}
    torch.testing.assert_close(got, fused, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("spec,winograd,size", [
    (t_vgg.TINY_SPEC, False, 32),
    (t_vgg.TINY_SPEC, False, 30),      # odd sides after the first pool
    ((8, 8, "M", 16, 16, "M"), False, 32),  # an epilogue in place, then one with the pool
    (SPEC, True, 32),                  # K14 (bias and ReLU inside), the stem's epilogue
], ids=["tiny", "tiny_odd", "two_block", "winograd"])
@pytest.mark.parametrize("fn", ["vgg_features", "vgg_fc2_partial"])
def test_vgg_stack_matches_the_parent_formulation(rng, dtype, spec, winograd, size, fn):
    """``vgg_features`` and ``vgg_fc2_partial`` (channels-last, bias-free
    convs, the epilogue) against the stack as it ran before, within the
    dtype's rounding (the parent's convs added their bias inside); frames
    that are not contiguous NHWC give the same features."""
    port = t_vgg.VGG(spec, size, 64, 3, torch.Generator().manual_seed(3), "cpu")
    with torch.no_grad():
        for conv in port.convs:  # nonzero biases, so the epilogue's add shows
            conv.b.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(conv.b.numel()))
    port.to(dtype)
    imgs = _t(rng.standard_normal((3, size, size, 3)).astype(np.float32)).to(dtype)
    want = _parent_fc2_partial(port, imgs, spec, winograd)
    if fn == "vgg_features":
        want = torch.relu(want + port.fc2_b)
    with torch.inference_mode():
        got = getattr(t_vgg, fn)(port, imgs, spec, winograd=winograd)
        strided = getattr(t_vgg, fn)(port, imgs.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                                     spec, winograd=winograd)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, **({"atol": 1e-5, "rtol": 1e-5} if dtype == torch.float32
                                             else {"atol": 2e-2, "rtol": 4 * BF16_ULP}))
    assert torch.equal(strided, got)


def test_stack_layouts_are_channels_last(rng):
    """``preprocess_frames`` writes contiguous NHWC; the VGG's conv weights
    are channels-last when built and stay so through a load, a cast to
    bf16 (``cast_vgg_weights``) and a save and load."""
    import io

    from mmbidaf_tpu_torch.data.frontend import cast_vgg_weights, frontend_init

    frames = _t((rng.random((2, 12, 16, 3)) * 255).astype(np.uint8))
    for dtype in (torch.float32, torch.bfloat16):
        out = t_vgg.preprocess_frames(frames, 10, dtype)
        assert out.shape == (2, 10, 10, 3) and out.dtype == dtype and out.is_contiguous()
    _, loaded = _vgg_pair(SPEC)
    fe = cast_vgg_weights(frontend_init(_cfg(False), SPEC, device="cpu"), "bfloat16")
    buf = io.BytesIO()
    torch.save(fe.vgg.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    for w in [c.w for c in loaded.convs] + [c.w for c in fe.vgg.convs] + \
             [v for k, v in saved.items() if k.endswith(".w")]:
        assert w.is_contiguous(memory_format=torch.channels_last) and not w.is_contiguous()


def _cudnn_flags():
    c = torch.backends.cudnn
    return (c.enabled, c.benchmark, c.deterministic, c.allow_tf32, c.conv.fp32_precision)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_direct_convs_pin_full_f32_with_cudnn_on(monkeypatch, rng, dtype):
    """Every f32 direct conv of ``vgg_features``, and the conv of K11-K13's
    plain version (f32 whatever its input), runs with cuDNN on and its conv
    precision at full f32 ("ieee"), not TF32, though the process's flag
    allows TF32; bf16 convs leave the flags as they are. Afterwards every
    flag is as it was, non-default ``benchmark`` and ``deterministic``
    included. (``torch.backends.cudnn.flags(allow_tf32=False)`` would have
    turned cuDNN off inside: its ``enabled`` defaults to False.)"""
    cudnn = torch.backends.cudnn
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*a, **k):
        seen.append((cudnn.enabled, cudnn.conv.fp32_precision))
        return conv2d(*a, **k)

    _, port = _vgg_pair(SPEC)
    port.to(dtype)
    imgs = _t(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)).to(dtype)
    x, w, b = (_t(a).to(dtype) for a in _conv_inputs(rng, 2, 6, 7, 5, 4))
    prior = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    try:
        cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = True, True, True
        before = _cudnn_flags()
        assert before[-1] == "tf32"
        monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
        t_vgg.vgg_features(port, imgs, SPEC)
        n_vgg = len(seen)
        conv_kernel.conv3x3_reference(x, w, b)
        after = _cudnn_flags()
    finally:
        cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = prior
    assert after == before
    assert n_vgg == 3 and len(seen) == 4
    vgg_precision = "ieee" if dtype == torch.float32 else "tf32"
    assert seen[:n_vgg] == [(True, vgg_precision)] * n_vgg
    assert seen[n_vgg:] == [(True, "ieee")]


def _spy(monkeypatch):
    """Record the C_in of every conv taken by K14's wrapper and by the
    direct ``F.conv2d`` route."""
    calls = {"winograd": [], "direct": []}
    wino, conv2d = winograd_kernel.winograd_conv3x3_fused, torch.nn.functional.conv2d

    def spy_wino(x, w, b=None, relu=False):
        calls["winograd"].append(x.shape[-1])
        return wino(x, w, b, relu)

    def spy_conv2d(x, w, *a, **k):
        calls["direct"].append(w.shape[1])
        return conv2d(x, w, *a, **k)

    monkeypatch.setattr(winograd_kernel, "winograd_conv3x3_fused", spy_wino)
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy_conv2d)
    return calls


def _cfg(winograd: bool, dtype="float32"):
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, compute_dtype=dtype,
        use_pallas_lstm=True, use_pallas_attention=True, use_pallas_melspec=True,
        use_winograd_conv=winograd))


@pytest.mark.parametrize("winograd", [True, False], ids=["winograd", "direct"])
def test_frontend_takes_the_winograd_route_for_cin_32_up(monkeypatch, rng, winograd):
    """``apply_frontend`` under ``use_winograd_conv`` sends exactly the
    C_in >= 32 convs to K14 and the 3-channel stem to the direct conv; with
    the flag off every conv is direct. (A frontend that ignored the flag
    ran direct convs where the JAX package runs Winograd.)"""
    from mmbidaf_tpu_torch.data.frontend import apply_frontend, frontend_init

    cfg = _cfg(winograd)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_audio=False))
    fe = frontend_init(cfg, SPEC, device="cpu")
    calls = _spy(monkeypatch)
    raw = {"frames": _t((rng.random((2, cfg.data.max_keyframes, 12, 16, 3)) * 255).astype(np.uint8)),
           "img_mask": torch.ones(2, cfg.data.max_keyframes)}
    with torch.inference_mode():
        out = apply_frontend(fe, raw, cfg, SPEC)
    assert out["images"].shape == (2, cfg.data.max_keyframes, cfg.model.img_feat_dim)
    if winograd:
        assert calls == {"winograd": [32, 32], "direct": [3]}
    else:
        assert calls == {"winograd": [], "direct": [3, 32, 32]}


def test_end_to_end_winograd_matches_jax():
    """The slice end to end with ``use_winograd_conv=True``: the port's
    ``make_end_to_end_decode`` against JAX's on the same weights and raw
    batch, f32, kernel flags on: picks equal, log-probs within 1e-4."""
    from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
    from mmbidaf_tpu.data.frontend import make_end_to_end_decode as j_end_to_end
    from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, model_from_jax

    cfg = _cfg(winograd=True)
    d = cfg.data
    rng = np.random.default_rng(11)
    wv = random_word_vectors(rng, d.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(0), cfg, jnp.asarray(wv))
    fe = j_frontend_init(jax.random.key(1), cfg, vgg_spec=SPEC)
    base = synthetic_batch(rng, cfg, batch_size=3)
    raw = {k: base[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    raw["frames"] = (rng.random((3, d.max_keyframes, 12, 16, 3)) * 255).astype(np.uint8)
    raw["waveform"] = (rng.standard_normal((3, d.max_audio_frames * d.hop_length + d.win_length))
                       * 0.1).astype(np.float32)
    j_lp, j_picks = j_end_to_end(cfg, vgg_spec=SPEC)(
        params, fe, {k: jnp.asarray(v) for k, v in raw.items()})
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    model = model_from_jax(np_tree(params), cfg, device="cpu")
    front = frontend_from_jax(np_tree(fe), cfg, SPEC, device="cpu")
    lp, picks = make_end_to_end_decode(cfg, SPEC)(model, front,
                                                  {k: _t(v) for k, v in raw.items()})
    np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("name", [*j_vgg.VARIANTS, "vgg11"])
def test_spec_for_variant_matches_jax(name):
    assert t_vgg.VARIANTS == j_vgg.VARIANTS
    if name not in j_vgg.VARIANTS:
        for fn in (t_vgg.spec_for_variant, j_vgg.spec_for_variant):
            with pytest.raises(ValueError, match="unknown vgg_variant"):
                fn(name)
        return
    assert t_vgg.spec_for_variant(name) == j_vgg.spec_for_variant(name)


def test_kernel_parity_tool_cpu_dry_run(tmp_path):
    """``python -m mmbidaf_tpu_torch.tools.kernel_parity --device cpu``:
    every row passes (each wrapper runs its plain version on the CPU) and
    the report covers K1-K14."""
    from mmbidaf_tpu_torch.tools import kernel_parity

    out = tmp_path / "parity.json"
    assert kernel_parity.main(["--device", "cpu", "--batch", "2", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and report["n_fail"] == 0
    assert report["n_rows"] == len(report["results"]) == 26
    assert all(r["ok"] for r in report["results"])
    assert sorted({k for r in report["results"] for k in r["kernels"]},
                  key=lambda k: int(k[1:])) == list(kernel_parity.KERNELS)


def test_kernel_parity_tool_fails_a_wrong_kernel(monkeypatch):
    """A row whose kernel disagrees with its plain version fails, and the
    tool exits non-zero."""
    from mmbidaf_tpu_torch.tools import kernel_parity

    def wrong(x, w, b, relu=True):
        return conv_kernel.conv3x3_reference(x, w, b, relu) + 0.5

    monkeypatch.setattr(conv_kernel, "conv3x3_same_acc", wrong)
    monkeypatch.setattr(kernel_parity, "CONV_LAYERS", (("small", 8, 4, 6),))
    assert kernel_parity.main(["--device", "cpu", "--batch", "1"]) == 1
