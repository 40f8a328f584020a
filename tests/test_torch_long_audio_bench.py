"""The long-audio serving configuration of the port's benchmark
(``port_bench/configs/mmbidaf_long_audio.json``, config 6) on the CPU: its
file keeps config 6's values, and the benchmark's serving program at small
widths but with config 6's audio framing (4096 frames, n_fft 512, hop 160,
window 400, 64 mels, 40 MFCCs) takes the long-audio dispatch and agrees
with the benchmark's plain reference (``port_bench/reference``), on seeded
random weights.

Tolerances: the program runs in f32 here (the cell serves in bf16; the
card's run holds that to the cell's limits). The reference computes the
MFCC in f64 and the program in f32, then both walk the 4096-step audio
BiLSTM in f32 with sums in different orders: picks equal, the served pick
the reference's best, and log-probabilities within ``LOGP_ATOL`` of the
reference's. Five seeds read 1.2e-7 (one f32 ulp at -1 to -2) and the
same program in bf16 1.3e-5 to 8.8e-5, so 2e-6 leaves the f32 program
16× room and fails the lower precision. MFCCs reach ~110 on the cell's
noise; the f32 chain lies 4.6e-5 to 6.1e-5 from the f64 MFCC on those
seeds, held to ``MFCC_ATOL`` = 5e-4, under the 1e-3 by which the port
holds K3 to its plain version (``ops/cuda/melspec_kernel.py``).
"""

import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "port_bench")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from pbench import check, core, spec  # noqa: E402
from reference import mmbidaf_ref as ref  # noqa: E402

from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, melspec_kernel  # noqa: E402

CELL = "serve.long_audio.b16"
LOGP_ATOL = 2e-6
MFCC_ATOL = 5e-4
SEED = 2**31 + 907


def _small_files():
    """The cell's configuration at small widths in f32, config 6's audio
    framing kept whole, and its traffic at B=2 from one batch."""
    bench = spec.load_benchmark()
    w = spec.workload(bench, CELL)
    cfg_file = spec.config_file(bench, w["config"])
    cfg_file["model"].update(hidden_size=8, emb_dim=12, img_feat_dim=20)
    cfg_file["data"].update(max_sentences=7, max_words=5, max_keyframes=3, vocab_size=50,
                            image_size=32)
    cfg_file["programs"]["serve"]["model"]["compute_dtype"] = "float32"
    mix = dict(spec.traffic(w["traffic"]), batch=2, pool=1, frame_hw=[40, 48])
    return spec.program_config(cfg_file, "serve"), mix


def test_configuration_keeps_config_6():
    """Every model and data value config 6 gives is the file's; the mesh is
    the one cut, named in ``reduced`` with its published value; the kernel
    flags are set only in the serving program's overlay."""
    with open(os.path.join(REPO, "examples", "configs", "config6_sp_long_audio.json")) as f:
        published = json.load(f)
    bench = spec.load_benchmark()
    cfg_file = spec.config_file(bench, "mmbidaf_long_audio")
    for section in ("model", "data"):
        for key, value in published[section].items():
            if key in cfg_file[section]:
                assert cfg_file[section][key] == value, key
            else:
                assert cfg_file["programs"]["serve"][section][key] == value, key
    assert cfg_file["reduced"]["mesh"]["published"] == published["mesh"]
    assert cfg_file["mesh"] == cfg_file["reduced"]["mesh"]["run"] == {
        "num_data": 1, "num_seq": 1, "sp_audio": False}
    entry = next(c for c in bench["configs"] if c["name"] == "mmbidaf_long_audio")
    assert entry["reduced"] == ["mesh"] == sorted(cfg_file["reduced"])
    d = cfg_file["data"]
    assert (d["max_audio_frames"], d["n_fft"], d["hop_length"], d["win_length"], d["n_mels"],
            d["n_mfcc"]) == (4096, 512, 160, 400, 64, 40)
    serve = cfg_file["programs"]["serve"]["model"]
    assert serve["use_pallas_attention"] and serve["use_pallas_lstm"] and serve["use_pallas_melspec"]
    assert list(cfg_file["programs"]) == ["serve"]


def test_long_audio_dispatch_at_the_cells_shapes():
    """At the cell's shapes the MFCC leaves K3 (its whole example, 20.2 MB,
    is past K3's 8 MB) and K2's wrapper hands the audio block (T_q=4096 at
    D=256) to K9, the image block (T_q=16) to its cluster route."""
    bench = spec.load_benchmark()
    cfg = spec.program_config(spec.config_file(bench, "mmbidaf_long_audio"), "serve")
    d, D = cfg["data"], 2 * cfg["model"]["hidden_size"]
    bins = d["n_fft"] // 2 + 1
    assert not melspec_kernel.mfcc_fused_fits(d["max_audio_frames"], d["win_length"], bins, d["n_mels"])
    assert 4 * d["max_audio_frames"] * (d["win_length"] + 3 * bins + d["n_mels"]) == 20_234_240
    assert bidaf_kernel.bidaf_route(d["max_sentences"], d["max_audio_frames"], D) == "K9"
    assert bidaf_kernel.bidaf_route(d["max_sentences"], d["max_keyframes"], D) == "cluster"


def test_long_audio_serving_agrees_with_the_reference(monkeypatch):
    """The benchmark's serving program at small widths with config 6's audio
    framing: K4's raw mel is called and K3 is not, and the picks and their
    log-probabilities agree with the plain reference on seeded weights."""
    cfg, mix = _small_files()
    calls = {"log_mel_fused": [], "mfcc_fused": 0}
    real_log_mel = melspec_kernel.log_mel_fused

    def log_mel_spy(frames, consts, log=True):
        calls["log_mel_fused"].append((tuple(frames.shape), log))
        return real_log_mel(frames, consts, log=log)

    def mfcc_spy(frames, consts):
        calls["mfcc_fused"] += 1
        raise AssertionError("K3 called past its bound")

    monkeypatch.setattr(melspec_kernel, "log_mel_fused", log_mel_spy)
    monkeypatch.setattr(melspec_kernel, "mfcc_fused", mfcc_spy)
    w, pool = core.make_inputs(cfg, mix, SEED, "cpu")
    prog = spec.program("serve").build(cfg, mix, w, SEED, "cpu")
    (raw,) = pool
    assert raw["waveform"].shape == (2, 4096 * 160 + 400)
    log_p, picks = prog.call(raw)
    assert calls == {"log_mel_fused": [((2, 4096, 400), False)], "mfcc_fused": 0}

    ref_logp, ref_picks = ref.serve(w["model"], w["vgg"], raw, cfg)
    assert torch.equal(picks.long(), ref_picks)
    got = check.serve_numbers(log_p, picks, ref_logp, raw["sent_mask"], True)
    assert got["pick_gap"] == 0.0 and got["logp_err"] < LOGP_ATOL, got


def test_audio_features_agree_with_the_reference_mfcc():
    """The port's long-audio MFCC (K4's raw mel, dB against each example's
    maximum, DCT) against the reference's f64 MFCC on the cell's noise
    waveform, within ``MFCC_ATOL``."""
    from mmbidaf_tpu_torch.ops import audio

    cfg, mix = _small_files()
    d = cfg["data"]
    gen = torch.Generator().manual_seed(5)
    wave = torch.randn(2, 4096 * 160 + 400, generator=gen) * mix["waveform_std"]
    consts = audio.make_audio_frontend_consts(d["sample_rate"], d["n_fft"], d["win_length"],
                                              d["n_mels"], d["n_mfcc"], device="cpu")
    got = audio.waveform_to_features(wave, consts, d["win_length"], d["hop_length"], 4096,
                                     fused=True)
    want = ref.mfcc(wave, d, 4096)
    assert got.shape == want.shape == (2, 4096, 40)
    err = (got - want).abs().amax().item()
    assert err < MFCC_ATOL, err
    assert want.abs().amax().item() > 50
