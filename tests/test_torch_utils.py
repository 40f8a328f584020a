"""The port's ``utils/`` (FLOP counts, timing and tracing helpers, the
benchmark's configuration) and its device-op profiler
(``tools/device_profile.py``) on the CPU, against the JAX package's
``utils/`` and ``bench.py``.

The counts must equal the JAX package's exactly (the same arithmetic on the
same config fields). Against ``torch.utils.flop_counter.FlopCounterMode`` on
the plain CPU path at ``build_bench_config(quick=True)``, B=2: the model's
count within 1 % and the end-to-end count within 5 % (both count the same
GEMMs and convs; the resize's second contraction is counted over the
frame's width where the program contracts its height); the train step's
count 1.0-1.4× the counted one (its 3×-forward rule counts an input
gradient for the towers' first GEMMs, which autograd skips: the features
need none). ``utils.profiling`` passes the JAX package's
``tests/test_utils.py`` cases.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
from mmbidaf_tpu.config import config_from_json as j_config_from_json
from mmbidaf_tpu.ops import vgg as jvgg
from mmbidaf_tpu.utils import flops as jflops
from mmbidaf_tpu_torch.config import config_from_json
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC, VGG16_SPEC, VGG19_SPEC
from mmbidaf_tpu_torch.utils import bench_config, flops
from mmbidaf_tpu_torch.utils.profiling import Timer, debug_nans, timeit, trace

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "examples" / "configs").glob("*.json"))


def _configs(name):
    if name.startswith("bench"):
        quick = name == "bench_quick"
        return bench_config.build_bench_config(quick), jbench.build_bench_config(quick)
    path = str(REPO / "examples" / "configs" / name)
    return config_from_json(path), j_config_from_json(path)


@pytest.mark.parametrize("name", CONFIGS + ["bench_quick", "bench_full"])
def test_flop_counts_equal_jax(name):
    cfg, jcfg = _configs(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for spec, jspec in ((TINY_SPEC, jvgg.TINY_SPEC), (VGG16_SPEC, jvgg.VGG16_SPEC),
                        (VGG19_SPEC, jvgg.VGG19_SPEC)):
        assert spec == jspec
        assert flops.conv_stack_flops(spec, cfg.data.image_size, cfg.model.img_feat_dim) == \
            jflops.conv_stack_flops(jspec, cfg.data.image_size, cfg.model.img_feat_dim)
        for hw in ((240, 320), (1080, 1920)):
            assert flops.e2e_decode_flops_per_video(cfg, spec, hw) == \
                jflops.e2e_decode_flops_per_video(jcfg, jspec, hw)
    assert flops.resize_flops((240, 320), cfg.data.image_size) == \
        jflops.resize_flops((240, 320), cfg.data.image_size)
    assert flops.audio_frontend_flops(cfg) == jflops.audio_frontend_flops(jcfg)
    assert flops.model_flops(cfg) == jflops.model_flops(jcfg)
    for optimizer in ("adadelta", "adam", "sgd", "other"):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimizer=optimizer))
        jc = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, optimizer=optimizer))
        assert flops.train_step_flops(c, 32, 123_457) == jflops.train_step_flops(jc, 32, 123_457)


def test_vgg16_conv_flops_match_literature():
    """VGG-16's convs at 224² are a textbook ~15.3 GMACs (30.7 GFLOPs)."""
    f = flops.conv_stack_flops(VGG16_SPEC, 224, fc_dim=4096)
    conv_only = f - 2 * (512 * 7 * 7 * 4096) - 2 * (4096 * 4096)
    assert 30.0e9 < conv_only < 31.5e9


def test_peak_tflops_lookup():
    assert flops.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.4
    for name in ("cpu", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert flops.peak_bf16_tflops(name) is None


def test_bench_config_and_batch():
    """The port's bench configurations are ``bench.py``'s, field for field;
    its raw batch is made on the device at ``bench.py``'s shapes and dtypes,
    from its seed alike each time."""
    for quick in (True, False):
        assert dataclasses.asdict(bench_config.build_bench_config(quick)) == \
            dataclasses.asdict(jbench.build_bench_config(quick))
    cfg, jcfg = _configs("bench_quick")
    ref = jbench.make_raw_batch(np.random.default_rng(4), jcfg, 3)
    dev = bench_config.make_raw_batch_on_device(cfg, 3, "cpu")
    assert set(dev) == set(ref)
    for k, v in ref.items():
        assert tuple(dev[k].shape) == v.shape and str(dev[k].dtype).endswith(str(v.dtype)), k
    again = bench_config.make_raw_batch_on_device(cfg, 3, "cpu")
    assert all(torch.equal(dev[k], again[k]) for k in dev)
    assert int(dev["frames"].max()) > 200 and int(dev["text_ids"].min()) >= 2


def _quick_model(B=2):
    from mmbidaf_tpu_torch.data.frontend import frontend_init
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init

    cfg = bench_config.build_bench_config(True)
    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    model = mmbidaf_init(cfg, wv, "cpu", seed=0)
    fe = frontend_init(cfg, TINY_SPEC, "cpu", seed=1)
    return cfg, rng, model, fe, bench_config.make_raw_batch_on_device(cfg, B, "cpu")


def test_counts_against_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode

    from mmbidaf_tpu_torch.data.frontend import apply_frontend
    from mmbidaf_tpu_torch.data.synthetic import synthetic_batch
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode
    from mmbidaf_tpu_torch.train.loop import init_train_state, make_train_step

    B = 2
    cfg, rng, model, fe, raw = _quick_model(B)
    with torch.inference_mode():
        batch = apply_frontend(fe, raw, cfg, TINY_SPEC)
        with FlopCounterMode(display=False) as fc:
            mmbidaf_decode(model, batch, cfg)
        model_ratio = flops.model_flops(cfg) * B / fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            mmbidaf_decode(model, apply_frontend(fe, raw, cfg, TINY_SPEC), cfg)
        e2e_ratio = flops.e2e_decode_flops_per_video(cfg, TINY_SPEC) * B / fc.get_total_flops()
    assert abs(model_ratio - 1) < 0.01, model_ratio
    assert abs(e2e_ratio - 1) < 0.05, e2e_ratio
    n_params = sum(p.numel() for p in model.parameters())
    state = init_train_state(model, cfg, seed=1)
    data = {k: torch.from_numpy(v) for k, v in synthetic_batch(rng, cfg, batch_size=B).items()}
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg)(state, data)
    train_ratio = flops.train_step_flops(cfg, B, n_params) / fc.get_total_flops()
    assert 1.0 < train_ratio < 1.4, train_ratio


# -- utils.profiling: the JAX package's tests/test_utils.py cases ------------


def test_timeit_returns_stats():
    x = torch.ones(64, 64)
    stats = timeit(lambda x: (x @ x).sum(), x, iters=3)
    assert stats["p50_s"] > 0 and stats["min_s"] <= stats["p50_s"] and stats["iters"] == 3
    assert set(stats) == {"p50_s", "mean_s", "min_s", "iters"}


def test_timer():
    with Timer() as t:
        sum(range(1000))
    assert t.elapsed_s >= 0


def test_debug_nans_catches():
    with debug_nans():
        with pytest.raises(FloatingPointError):
            torch.zeros(()) / 0.0
        torch.ones(3) * 2  # finite values pass
    # the check ends with the context
    assert torch.isnan(torch.zeros(()) / 0.0)
    with debug_nans(False):
        torch.zeros(()) / 0.0


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        torch.ones(8, 8) * 2
    assert any(files for _, _, files in os.walk(d))
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0


# -- tools/device_profile.py --------------------------------------------------


@pytest.mark.parametrize("mode", ["serve", "train"])
def test_device_profile_quick_on_the_cpu(mode, capsys):
    """``--quick --device cpu``: the table of CPU operations, the JSON rows
    and the summary (no MFU without a known card; the hand kernels' groups
    empty on the plain path)."""
    import json

    from mmbidaf_tpu_torch.tools import device_profile

    res = device_profile.main(["--mode", mode, "--quick", "--device", "cpu", "--steps", "1",
                               "--batch", "2", "--top", "5"])
    table = capsys.readouterr().out.splitlines()
    assert table[0].startswith(f"# {mode} x1 steps, batch 2, float32, cpu")
    assert len(table) == 2 + 5 + len(device_profile.KERNEL_GROUPS[mode])
    assert res["mfu"] is None and res["idle"] is None and res["step_s"] > 0
    assert res["rows"] and abs(sum(r["pct"] for r in res["rows"]) - 100) < 1e-6
    assert res["kernels"] == {k: 0.0 for k in device_profile.KERNEL_GROUPS[mode]}
    if mode == "serve":
        device_profile.main(["--quick", "--device", "cpu", "--steps", "1", "--batch", "2",
                             "--top", "3", "--json"])
        lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        assert len(lines) == 4 and set(lines[0]) == {"name", "ms", "calls", "pct", "kernel"}
        assert lines[-1]["summary"]["flops"] == res["flops"]


def test_device_profile_groups_name_the_hand_kernels():
    """The table's groups put each hand kernel's device symbols under its
    number, and nothing else."""
    from mmbidaf_tpu_torch.tools.device_profile import KERNEL_GROUPS, group_ms, kernel_of

    serve, train = KERNEL_GROUPS["serve"], KERNEL_GROUPS["train"]
    assert kernel_of("void bilstm_cluster_kernel<4, false>(float const*)", serve) == "K1 bilstm"
    assert kernel_of("void bilstm_cluster_kernel<4, true>(float const*)", train) == \
        "K5 bilstm forward"
    assert kernel_of("bidaf_fwd_cluster_kernel(float const*)", serve) == "K2 bidaf"
    assert kernel_of("void logmel_fft_kernel<true>(float const*)", serve) == "K3 mfcc"
    assert kernel_of("bilstm_bptt_cluster_kernel", train) == "K6 bilstm backward"
    assert kernel_of("bidaf_drop_fwd_cluster_kernel", train) == "K7 bidaf forward"
    assert kernel_of("bidaf_drop_bwd_cluster_kernel", train) == "K8 bidaf backward"
    assert kernel_of("sm90_xmma_gemm_bf16bf16_bf16f32", serve) is None
    rows = [{"name": "bidaf_fwd_cluster_kernel", "ms": 0.25}, {"name": "gemm", "ms": 3.0},
            {"name": "mfcc_dct_kernel", "ms": 0.5}, {"name": "logmel_fft_kernel<0>", "ms": 0.25}]
    assert group_ms(rows, serve) == {"K1 bilstm": 0.0, "K2 bidaf": 0.25, "K3 mfcc": 0.75}


def test_no_module_of_the_port_shadows_the_standard_library():
    """No module under ``mmbidaf_tpu_torch`` bears a standard library name
    (a ``profile.py`` first on ``sys.path`` breaks ``torch._dynamo``), and
    ``cProfile.run`` works in a process that imported the profiler with the
    tools' directory first on its path."""
    pkg = REPO / "mmbidaf_tpu_torch"
    names = {p.stem for p in pkg.rglob("*.py")} | {p.name for p in pkg.rglob("*") if p.is_dir()}
    assert not names & set(sys.stdlib_module_names), names & set(sys.stdlib_module_names)
    code = ("import sys; sys.path.insert(0, 'mmbidaf_tpu_torch/tools'); "
            "import mmbidaf_tpu_torch.tools.device_profile, cProfile; cProfile.run('1 + 1')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120)
    assert r.returncode == 0 and "function calls" in r.stdout, r.stderr
