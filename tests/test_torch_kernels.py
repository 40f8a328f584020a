"""The port's kernel modules on the CPU, against the JAX Pallas kernels run
in interpret mode (as ``tests/test_pallas_kernels.py`` runs them), plus the
build and device rules that hold without a card.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; the
CUDA kernels themselves are compared with those plain versions on the card
by ``chip_smoke.py``. Tolerances: f32 on both sides, sums in different
orders (XLA vs PyTorch), so ``atol=2e-5`` on O(1) values; the MFCC values
reach ~100, so it is held at ``rtol=2e-4, atol=2e-4`` as the JAX package
holds its own fused MFCC kernel against its jnp chain.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.ops import audio as j_audio
from mmbidaf_tpu.ops.bidaf import bidaf_init
from mmbidaf_tpu.ops.lstm import bilstm_init
from mmbidaf_tpu.ops.pallas.bidaf_kernel import bidaf_attention_fused as j_bidaf_fused
from mmbidaf_tpu.ops.pallas.lstm_kernel import bilstm_pallas
from mmbidaf_tpu.ops.pallas.melspec_kernel import mfcc_fused as j_mfcc_fused
from mmbidaf_tpu.ops.pallas.melspec_kernel import mfcc_fused_fits as j_fits
from mmbidaf_tpu_torch.interop.from_jax import load_pytree
from mmbidaf_tpu_torch.ops import audio as t_audio
from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, build, lstm_kernel, melspec_kernel
from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

GEN = torch.Generator().manual_seed(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_bilstm_wrapper_matches_pallas(rng):
    """Ragged rows, a fully masked row (zero state, zero output in both
    directions), bf16 operands (projection rounded in bf16, recurrence in
    f32 — the Pallas contract)."""
    B, T, D, h = 5, 11, 6, 8
    jp = bilstm_init(jax.random.key(3), D, h)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([11, 5, 0, 1, 8])[:, None]).astype(np.float32)
    port = BiLSTMParams(D, h, GEN, "cpu")
    load_pytree(port, jax.tree.map(np.asarray, jp))
    before = lstm_kernel.bilstm_cuda.launches
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        out, (h_n, c_n) = lstm_kernel.bilstm_cuda(port.to(dtype), _t(x).to(dtype), _t(mask).to(dtype))
        ref_out, (ref_h, ref_c) = bilstm_pallas(
            jax.tree.map(lambda a: a.astype(jdtype), jp), jnp.asarray(x, jdtype),
            jnp.asarray(mask, jdtype), interpret=True)
        assert out.dtype == h_n.dtype == torch.float32
        for o, r in ((out, ref_out), (h_n, ref_h), (c_n, ref_c)):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5)
        assert not out[2].any() and not h_n[2].any() and not c_n[2].any()
    # the plain path on the CPU is not a launch
    assert lstm_kernel.bilstm_cuda.launches == before


def test_bilstm_reference_equals_port_scan(rng):
    """The kernel's plain version and the JAX-scan port agree in f32."""
    from mmbidaf_tpu_torch.ops.lstm import bilstm_apply

    port = BiLSTMParams(4, 6, GEN, "cpu")
    x = _t(rng.standard_normal((3, 7, 4)).astype(np.float32))
    mask = _t((np.arange(7)[None] < np.array([7, 2, 0])[:, None]).astype(np.float32))
    a = lstm_kernel.bilstm_reference(port, x, mask)
    b = bilstm_apply(port, x, mask)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(a[1][0].numpy(), b[1][0].numpy(), atol=1e-6)


def test_bidaf_wrapper_matches_pallas(rng):
    """A fully masked q row and a fully masked c column give the uniform
    softmax of the -1e30 fill; bf16 inputs are cast to f32 as on the TPU."""
    B, T_c, T_q, D = 3, 12, 9, 16
    jp = dict(bidaf_init(jax.random.key(0), D), bias=jnp.float32(-0.2))
    c = rng.standard_normal((B, T_c, D)).astype(np.float32)
    q = rng.standard_normal((B, T_q, D)).astype(np.float32)
    c_mask = (np.arange(T_c)[None] < np.array([12, 0, 5])[:, None]).astype(np.float32)
    q_mask = (np.arange(T_q)[None] < np.array([9, 4, 0])[:, None]).astype(np.float32)
    port = BiDAFParams(D, GEN, "cpu")
    load_pytree(port, jax.tree.map(np.asarray, jp))
    ours = bidaf_kernel.bidaf_attention_fused(port, _t(c), _t(q), _t(c_mask), _t(q_mask))
    ref = j_bidaf_fused(jp, *(jnp.asarray(v) for v in (c, q, c_mask, q_mask)), interpret=True)
    assert ours.shape == (B, T_c, 4 * D) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)
    # batch 2's q is fully masked: C2Q is the plain mean of q over T_q
    np.testing.assert_allclose(ours[2, :, D:2 * D].numpy(),
                               np.broadcast_to(q[2].mean(0), (T_c, D)), atol=1e-5)
    bf = port.to(torch.bfloat16)
    ours_bf = bidaf_kernel.bidaf_attention_fused(
        bf, _t(c).bfloat16(), _t(q).bfloat16(), _t(c_mask).bfloat16(), _t(q_mask).bfloat16())
    ref_bf = j_bidaf_fused(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
                           *(jnp.asarray(v, jnp.bfloat16) for v in (c, q, c_mask, q_mask)),
                           interpret=True)
    assert ours_bf.dtype == torch.float32
    np.testing.assert_allclose(ours_bf.numpy(), np.asarray(ref_bf), atol=2e-5)


def test_bidaf_shared_memory_bound():
    """The bench's audio attention (T_c=32, T_q=512, D=256) fits K2's
    cluster plan; the long-audio T_q=4096 does not (the wrapper routes such
    shapes to K9 on the card, which chip_smoke.py checks)."""
    assert bidaf_kernel.fused_plan(32, 512, 256).smem_fwd <= bidaf_kernel.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="no BiDAF cluster plan"):
        bidaf_kernel.fused_plan(32, 4096, 256)


def test_mfcc_wrapper_matches_pallas(rng):
    """Strided frames straight from the waveform, and a silent example:
    all-zero frames give max -100 dB and an all-zero MFCC."""
    n_fft, win, hop, T = 64, 48, 16, 37
    consts = t_audio.make_audio_frontend_consts(16000, n_fft, win, 12, 8, device="cpu")
    sig = rng.standard_normal((3, (T - 1) * hop + win)).astype(np.float32)
    sig[1] = 0.0
    frames = t_audio.frame_signal(_t(sig), win, hop, T)
    ours = melspec_kernel.mfcc_fused(frames, consts)
    ref = j_mfcc_fused(j_audio.frame_signal(jnp.asarray(sig), win, hop, T),
                       {k: jnp.asarray(v.numpy()) for k, v in consts.items()}, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    assert not ours[1].any()


@pytest.mark.parametrize("T,win,bins,n_mels", [(512, 400, 257, 64), (4096, 400, 257, 64),
                                               (11, 48, 33, 12), (2000, 400, 257, 64)])
def test_mfcc_fused_fits_is_the_jax_bound(T, win, bins, n_mels):
    assert melspec_kernel.mfcc_fused_fits(T, win, bins, n_mels) == j_fits(T, win, bins, n_mels)


def test_nvcc_command_targets_sm90a(tmp_path):
    """Every source compiles for sm_90a (wgmma/setmaxnreg exist only there),
    one nvcc per source, and one link makes the shared library; nvcc is not
    run here."""
    objects = []
    for src in build.SOURCES:
        cmd = build.compile_command(src, tmp_path / f"{src}.o")
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-c", "-O3", "-std=c++17"):
            assert flag in cmd
        assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
        assert cmd[-1] == str(build.CSRC / src)
        objects.append(cmd[cmd.index("-o") + 1])
    link = build.link_command(objects, tmp_path / "lib.so")
    assert "-shared" in link and link[-len(objects):] == objects
    assert {"lstm_bwd.cu", "bidaf_bwd.cu", "winograd.cu", "conv3x3.cu", "preprocess.cu"} <= set(
        build.SOURCES)
    assert build.library_path().parent == build.BUILD_DIR
    assert build.library_path().name.endswith(".so")


def test_build_lists_every_source_and_header():
    """Every ``*.cu`` under ``csrc/`` is compiled and every ``*.cuh`` is in
    the build hash: a header left out would let an edit to it load a stale
    library."""
    assert sorted(build.SOURCES) == sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert sorted(build.HEADERS) == sorted(p.name for p in build.CSRC.glob("*.cuh"))


def test_ptxas_resources_reads_the_build_log():
    """The registers, spills and static shared memory that ptxas reports for
    each kernel, as the build log keeps them."""
    log = """$ nvcc -Xptxas -v -c winograd.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2tc19winograd_mma_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc19winograd_mma_kernelEv
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4stemv' for 'sm_90a'
ptxas info    : Function properties for _Z4stemv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 1024 bytes smem, 400 bytes cmem[0]
"""
    assert build.ptxas_resources(log) == {
        "_ZN2tc19winograd_mma_kernelEv": {"registers": 128, "spill_stores": 8, "spill_loads": 12,
                                          "smem": 0},
        "_Z4stemv": {"registers": 40, "spill_stores": 0, "spill_loads": 0, "smem": 1024},
    }


def test_cuda_requests_raise_without_a_card():
    """Asking for the card on a host without one raises; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from mmbidaf_tpu.config import tiny_test_config
    from mmbidaf_tpu_torch import resolve_device
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mmbidaf_init(cfg, np.zeros((cfg.data.vocab_size, cfg.model.emb_dim), np.float32), "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Summarizer.init_random(cfg, device="cuda:0")
    from mmbidaf_tpu_torch.ops.cuda import conv_kernel, preprocess_kernel, winograd_kernel
    from mmbidaf_tpu_torch.tools import kernel_parity

    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_parity.main([])  # the tool's default device is the card
    # a tensor on neither the CPU nor the card reaches no plain version
    x, w, b = (torch.empty(s, device="meta") for s in ((1, 5, 5, 64), (3, 3, 64, 8), (8,)))
    for fn in (conv_kernel.conv3x3_same, conv_kernel.conv3x3_same_acc,
               conv_kernel.conv3x3_same_db, winograd_kernel.winograd_conv3x3_fused):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        preprocess_kernel.preprocess_frames_fused(
            torch.empty(1, 6, 6, 3, dtype=torch.uint8, device="meta"), 4)


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port; neither jax nor
    any module of the JAX package ``mmbidaf_tpu`` comes with it."""
    import pkgutil

    import mmbidaf_tpu_torch

    mods = sorted(m.name for m in pkgutil.walk_packages(mmbidaf_tpu_torch.__path__,
                                                        "mmbidaf_tpu_torch."))
    assert {"mmbidaf_tpu_torch.serving", "mmbidaf_tpu_torch.train.loop",
            "mmbidaf_tpu_torch.data.containers", "mmbidaf_tpu_torch.ops.cuda.build"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'mmbidaf_tpu')\n"
            "             or m.startswith(('jax.', 'jaxlib', 'mmbidaf_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
