"""The cell ``serve.long_audio.b16`` at CPU size end to end, its control
judged not correct, K9's bound, and the long-audio readers on a trace
built by hand."""

import json
import time
import types

import pytest

from pbench import audio_chain, check, core, counts, spec
from pbench.trace import Trace

H100 = counts.PEAKS["h100 80gb hbm3"]
CELL = "serve.long_audio.b16"
US = 1000  # ns


@pytest.mark.parametrize("traced", [False, True])
def test_cell_end_to_end_prints_one_json_line(tiny, traced, capsys):
    """Untraced, the end-to-end metrics; traced on the CPU, no device metric."""
    import run

    bench, cfg, mix = tiny(CELL)
    out = core.run_cell(bench, CELL, 2**31 + 29, 0.5, traced, "cpu", time.perf_counter(), cfg, mix)
    run.report(core.result_line(bench, out, CELL, traced, spec.limits(CELL)))
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] is True and last["attempted"] > 0
    want = set() if traced else {m["name"] for m in spec.metrics_of(bench, CELL, "end_to_end")}
    assert set(last["metrics"]) == want


def test_control_is_not_correct(tiny):
    """fp8 products where the program computes in bf16, in the program's
    place, fail the cell's limits; the program on the same seed passes."""
    _, cfg_file, mix = tiny(CELL)
    cfg = spec.program_config(cfg_file, "serve")
    read = spec.program("serve").readings
    limits = spec.limits(CELL)
    assert check.judge(read(cfg, mix, 43, "program", "cpu"), limits)[0]
    assert not check.judge(read(cfg, mix, 43, "control", "cpu"), limits)[0]


def test_k9_bound_at_the_cells_shape():
    """B=16, T_c=32, T_q=4096, D=256: 2.324 GFLOP at 67 TFLOP/s, 0.0347 ms,
    above the 69.7 MB of c, q and the output at 3.35 TB/s (0.0208 ms)."""
    bench = spec.load_benchmark()
    cfg = spec.program_config(spec.config_file(bench, "mmbidaf_long_audio"), "serve")
    assert 16 * counts.bidaf_flops(32, 4096, 256) / 1e9 == pytest.approx(2.3239, abs=1e-4)
    assert audio_chain.k9_bound_s(cfg, 16, H100) * 1e3 == pytest.approx(0.03469, abs=1e-5)
    nbytes = 4 * 16 * (32 * 256 + 4096 * 256 + 32 * 1024)
    assert nbytes / H100["hbm"] < audio_chain.k9_bound_s(cfg, 16, H100)


def test_long_audio_is_a_configuration_of_its_own():
    """Its source names config 6, so no other configuration has both its
    source and its reduced keys."""
    bench = spec.load_benchmark()
    ident = {c["name"]: (c["source"], sorted(c["reduced"])) for c in bench["configs"]}
    mine = ident.pop("mmbidaf_long_audio")
    assert "config6_sp_long_audio.json" in mine[0] and mine not in ident.values()


def _trace(host, device, window=(0, 2000)):
    """Times in microseconds; ``device``: ``(name, start, end, launch)``."""
    return Trace([(n, s * US, e * US, la * US) for n, s, e, la in device],
                 [(n, s * US, e * US) for n, s, e in host], {}, (window[0] * US, window[1] * US))


HOST = [
    ("frontend", 0, 400), ("frontend.vgg", 10, 300), ("frontend.audio", 300, 390),
    ("model", 400, 1900), ("model.image_tower", 500, 600), ("model.image_tower.bidaf", 580, 600),
    ("model.audio_tower", 600, 1800), ("model.audio_tower.bidaf", 1700, 1800),
]
DEVICE = [
    ("conv", 20, 280, 15),
    ("logmel_fft_kernel<2>", 310, 350, 305), ("elementwise_kernel", 350, 360, 355),
    ("gemm", 370, 380, 385),  # launched in frontend.audio by its host time
    ("void bilstm_cluster_kernel<4, false>(float const*)", 510, 570, 505),
    ("void bidaf_fwd_cluster_kernel(float const*)", 590, 595, 585),
    ("sm90_gemm", 605, 615, 602),
    ("void bilstm_cluster_kernel<4, false>(float const*)", 620, 1640, 610),
    ("void bidaf_tiled_cluster_kernel<true, false>(float const*)", 1710, 1790, 1705),
]
CFG = {"data": {"max_sentences": 32, "max_audio_frames": 4096}, "model": {"hidden_size": 128}}


def _run(trace, program="serve", units=2):
    return types.SimpleNamespace(program=program, trace=trace, cfg=CFG, batch=16, peaks=H100,
                                 window=types.SimpleNamespace(units=units))


@pytest.mark.parametrize("name,value", [
    ("audio_ms.serve", 0.060 / 2),                   # K4, the tail and the gemm
    ("audio_tower_ms.serve", (10 + 1020 + 80) / 2e3),
    ("audio_step_us.serve", 1020 / (2 * 4096)),      # K1 inside the audio tower only
    ("audio_bidaf_ms.serve", 0.080 / 2),
    ("bidaf_tiled_roofline.serve", 100.0 * 0.03468517253731344e-3 * 2 / 80e-6),
])
def test_long_audio_readers_on_a_trace_built_by_hand(name, value):
    read = spec.reader(name)
    assert read(_run(_trace(HOST, DEVICE))) == pytest.approx(value, rel=1e-9)
    assert read(_run(_trace(HOST, DEVICE), program="train")) is None
    assert read(_run(_trace(HOST, []))) is None
    if name != "bidaf_tiled_roofline.serve":
        # a program without the spans (an older commit) reads nothing
        bare = [ev for ev in HOST if "." not in ev[0]]
        assert read(_run(_trace(bare, DEVICE))) is None


@pytest.mark.cuda
def test_control_at_the_cells_size_on_the_card():
    """At the cell's own size, on three seeds: the program is correct and the
    control is not (``calibrate.py``'s readings)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size runs on the card")
    bench = spec.load_benchmark()
    mix = spec.traffic(spec.workload(bench, CELL)["traffic"])
    cfg = spec.program_config(spec.config_file(bench, "mmbidaf_long_audio"), "serve")
    read = spec.program("serve").readings
    limits = spec.limits(CELL)
    for seed in (8200000001, 8200000002, 8200000003):
        assert check.judge(read(cfg, mix, seed, "program", "cuda"), limits)[0]
        assert not check.judge(read(cfg, mix, seed, "control", "cuda"), limits)[0]
