"""Frozen serving artifacts of the port (``mmbidaf_tpu_torch/export.py``) on
the CPU, against the live port and the JAX package's artifacts.

The tiny config of ``tests/test_export.py`` (img_feat_dim 32, audio width
n_mfcc, B=2, frames 12x16), with the three kernel flags on: every serving
kernel is a ``torch.ops.mmbidaf`` custom op, so the exported graph holds
one node a BiLSTM layer, BiDAF block and MFCC, and on the CPU each op runs
its plain version. Tolerances: the port's artifact equals the live port
bit for bit (the same ops on the same inputs); against JAX's exported
program on the same weights and batch, picks equal and log-probs within
``atol=1e-5, rtol=1e-5``, the slice tests' f32 bound
(``tests/test_torch_slice.py``). The artifacts are built once each in
module-scoped fixtures.
"""

import collections
import dataclasses
import http.client
import importlib.util
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import wave as wave_mod
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mmbidaf_tpu import export as jexport
from mmbidaf_tpu import serving as jserving
from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
from mmbidaf_tpu_torch import export
from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.ops.audio import make_audio_frontend_consts
from mmbidaf_tpu_torch.ops.cuda import registry
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
from mmbidaf_tpu_torch.serving import DynamicBatcher, Summarizer

REPO = Path(__file__).resolve().parents[1]
HW = (12, 16)
B = 2


def _cfg(**model):
    cfg = tiny_test_config()
    kw = dict(img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
              use_pallas_attention=True, use_pallas_melspec=True)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **{**kw, **model}))


def _jcfg():
    cfg = j_tiny_config()  # JAX's kernel flags as tests/test_export.py runs them
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc))


def _random_raw(cfg, seed: int, rungs=None) -> dict:
    """A raw batch at the artifact's shapes: ragged masks (row 1 half
    valid), a silent second waveform."""
    rng = np.random.default_rng(seed)
    raw = {}
    for k, s in export._raw_specs(cfg, B, HW, rungs).items():
        if k == "text_ids":
            raw[k] = rng.integers(0, cfg.data.vocab_size, s.shape).astype(np.int32)
        elif k == "frames":
            raw[k] = (rng.random(s.shape) * 255).astype(np.uint8)
        elif k == "waveform":
            raw[k] = rng.standard_normal(s.shape).astype(np.float32)
            raw[k][1] = 0.0
        else:
            m = np.ones(s.shape, np.float32)
            m[1, ..., max(1, s.shape[-1] // 2):] = 0.0
            raw[k] = m
    return raw


def _live(summ, raw):
    lp, picks = summ._decode_batch_device({k: torch.from_numpy(v) for k, v in raw.items()})
    return lp.numpy(), picks.numpy()


@pytest.fixture(scope="module")
def weights():
    """JAX's tiny weights as numpy, and both packages' summarizer factories
    over them."""
    jcfg = _jcfg()
    base = jserving.Summarizer.init_random(jcfg, seed=3, vgg_spec=J_TINY)
    params, fe = jax.tree.map(np.asarray, base.params), jax.tree.map(np.asarray, base.fe_params)

    def port(cfg=None, **kw):
        return Summarizer.from_jax_params(params, fe, base.word2idx, cfg or _cfg(), TINY_SPEC,
                                          device="cpu", **kw)

    def jax_s(**kw):
        return jserving.Summarizer(base.params, base.fe_params, base.word2idx, jcfg, J_TINY, **kw)

    return port, jax_s


@pytest.fixture(scope="module")
def artifacts(weights, tmp_path_factory):
    """Greedy, beam (width 3) and bucketed greedy artifacts of the port, and
    JAX's greedy and beam artifacts of the same weights."""
    port, jax_s = weights
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name, kw, buckets in (("greedy", {}, None), ("beam", {"mode": "beam", "topk": 3}, None),
                              ("bucketed", {}, True)):
        s = port(**kw)
        export.export_summarizer(s, str(root / name), batch_size=B, frame_hw=HW, buckets=buckets)
        out[name] = (str(root / name), s)
    for name, kw in (("greedy", {}), ("beam", {"mode": "beam", "topk": 3})):
        jexport.export_summarizer(jax_s(**kw), str(root / f"jax_{name}"), batch_size=B, frame_hw=HW)
        out[f"jax_{name}"] = str(root / f"jax_{name}")
    return out


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_roundtrip_equals_live(artifacts, mode):
    """The loaded artifact gives the live port's picks and log-probs bit for
    bit."""
    path, summ = artifacts[mode]
    raw = _random_raw(summ.cfg, 0)
    lp, picks = export.ExportedDecoder(path, device="cpu").decode_raw(raw)
    live_lp, live_picks = _live(summ, raw)
    np.testing.assert_array_equal(picks, live_picks)
    np.testing.assert_array_equal(lp, live_lp)
    assert lp.shape == ((B, summ.cfg.model.max_decode_steps, summ.cfg.data.max_sentences)
                        if mode == "greedy" else (B,))


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_matches_jax_exported_program(artifacts, mode):
    """The port's artifact against JAX's ``ExportedDecoder`` on the same
    weights and numpy batch."""
    path, summ = artifacts[mode]
    raw = _random_raw(summ.cfg, 1)
    lp, picks = export.ExportedDecoder(path, device="cpu").decode_raw(raw)
    j_lp, j_picks = jexport.ExportedDecoder(artifacts[f"jax_{mode}"]).decode_raw(raw)
    np.testing.assert_array_equal(picks, j_picks)
    np.testing.assert_allclose(lp, j_lp, atol=1e-5, rtol=1e-5)


def _op_nodes(path: str) -> collections.Counter:
    ep = torch.export.load(os.path.join(path, "decode.pt2"))
    return collections.Counter(str(n.target) for n in ep.graph.nodes if n.op == "call_function")


def test_graph_holds_one_node_per_kernel_call(artifacts):
    """Five BiLSTM layers (word, sentence, image, audio, modeling), two BiDAF
    blocks, one MFCC and one conv epilogue a conv of the tiny VGG (two),
    each one node, and no separate bias add, ReLU or pool beside the
    epilogues; the recurrences are not unrolled: the only sigmoids left are
    the decoder cell's three a step and the highway gates'."""
    path, summ = artifacts["greedy"]
    m = summ.cfg.model
    nodes = _op_nodes(path)
    assert nodes["mmbidaf.bilstm.default"] == 5 * m.num_rnn_layers
    assert nodes["mmbidaf.bidaf.default"] == 2
    assert nodes["mmbidaf.mfcc.default"] == 1
    assert nodes["mmbidaf.conv_epilogue.default"] == 2
    assert nodes["mmbidaf.log_mel.default"] == nodes["mmbidaf.winograd_conv3x3.default"] == 0
    assert nodes["aten.max_pool2d.default"] == 0
    assert nodes["aten.sigmoid.default"] == 3 * m.max_decode_steps + m.num_highway_layers
    assert sum(v for k, v in nodes.items() if "mmbidaf." in k) == 10


@pytest.mark.parametrize("variant", ["logmel", "winograd"])
def test_graph_holds_the_k4_and_k14_nodes(tmp_path, variant):
    """The log-mel frontend exports one K4 node; the Winograd frontend one
    K14 node a conv with C_in >= 32 (here two), the convs with C_in < 32
    (here two) plain ones, each with its epilogue node; the pool after K14
    stays ``max_pool2d``."""
    from mmbidaf_tpu_torch.data.frontend import frontend_init
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init

    spec = TINY_SPEC
    if variant == "logmel":
        cfg = _cfg(audio_feat_dim=tiny_test_config().data.n_mels)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, audio_features="logmel"))
    else:
        cfg, spec = _cfg(use_winograd_conv=True), (8, "M", 32, 32, 32, "M")
    wv = np.random.default_rng(0).standard_normal((cfg.data.vocab_size, cfg.model.emb_dim))
    s = Summarizer(mmbidaf_init(cfg, wv.astype(np.float32), "cpu"),
                   frontend_init(cfg, spec, "cpu"), {"w0": 0}, cfg, spec)
    export.export_summarizer(s, str(tmp_path), batch_size=B, frame_hw=HW)
    nodes = _op_nodes(str(tmp_path))
    if variant == "logmel":
        assert nodes["mmbidaf.log_mel.default"] == 1 and nodes["mmbidaf.mfcc.default"] == 0
        assert nodes["mmbidaf.conv_epilogue.default"] == 2
    else:
        assert nodes["mmbidaf.winograd_conv3x3.default"] == 2
        assert nodes["aten.conv2d.default"] + nodes["aten.convolution.default"] == 2
        assert nodes["mmbidaf.conv_epilogue.default"] == 2
        assert nodes["aten.max_pool2d.default"] == 1
    raw = _random_raw(cfg, 2)
    lp, picks = export.ExportedDecoder(str(tmp_path), device="cpu").decode_raw(raw)
    live_lp, live_picks = _live(s, raw)
    np.testing.assert_array_equal(picks, live_picks)
    np.testing.assert_array_equal(lp, live_lp)


def test_fresh_process_loads_without_the_model_code(artifacts, tmp_path):
    """A process that imports only ``export`` (torch, numpy, the op
    registrations) loads and decodes the artifact; ``models``, ``serving``,
    ``data.frontend``, jax and the JAX package are never imported."""
    path, summ = artifacts["greedy"]
    raw = _random_raw(summ.cfg, 3)
    np.savez(tmp_path / "raw.npz", **raw)
    want_lp, want_picks = export.ExportedDecoder(path, device="cpu").decode_raw(raw)
    code = (
        "import sys, numpy as np\n"
        "from mmbidaf_tpu_torch.export import ExportedDecoder\n"
        f"raw = dict(np.load({str(tmp_path / 'raw.npz')!r}))\n"
        f"log_p, picks = ExportedDecoder({path!r}, device='cpu').decode_raw(raw)\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, log_p=log_p, picks=picks)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'mmbidaf_tpu', "
        "'mmbidaf_tpu_torch.models', 'mmbidaf_tpu_torch.serving', 'mmbidaf_tpu_torch.data.frontend')"
        " or m.startswith(('jax.', 'mmbidaf_tpu.', 'mmbidaf_tpu_torch.models.')))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(got["picks"], want_picks)
    np.testing.assert_array_equal(got["log_p"], want_lp)


# -- the custom ops -------------------------------------------------------------


def _op_samples():
    """Small ragged operands for each op: a fully masked row, a silent audio
    example, odd image sides, a conv with and without bias."""
    g = torch.Generator().manual_seed(0)
    H = 4
    mask = torch.tensor([[1.0, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]])
    lstm = (torch.randn(3, 5, 8 * H, generator=g), mask, torch.randn(2, H, 4 * H, generator=g) * 0.3)
    D = 6
    bidaf = (torch.randn(2, 5, D, generator=g), torch.randn(2, 4, D, generator=g),
             torch.tensor([[1.0, 1, 1, 0, 0], [0, 0, 0, 0, 0]]), torch.tensor([[1.0, 1, 0, 0], [1, 1, 1, 1]]),
             torch.randn(D, generator=g), torch.randn(D, generator=g), torch.randn(D, generator=g),
             torch.tensor(0.25))
    d = tiny_test_config().data
    c = make_audio_frontend_consts(d.sample_rate, d.n_fft, d.win_length, d.n_mels, d.n_mfcc, d.fmin,
                                   d.fmax, device="cpu")
    frames = torch.randn(2, 6, d.win_length, generator=g)
    frames[1] = 0.0  # a silent example
    x = torch.randn(1, 5, 7, 4, generator=g)
    w = torch.randn(3, 3, 4, 6, generator=g)
    y = torch.randn(2, 8, 5, 7, generator=g)
    y_cl = y.contiguous(memory_format=torch.channels_last)
    return {
        "K1": [lstm],
        "K2": [bidaf],
        "K3": [(frames, c["cos"], c["sin"], c["mel_fb"], c["dct"])],
        "K4": [(frames, c["cos"], c["sin"], c["mel_fb"], True),
               (frames[0], c["cos"], c["sin"], c["mel_fb"], False)],
        "K14": [(x, w, torch.randn(6, generator=g), True), (x, w, None, False)],
        # odd sides; channels-last and NCHW storage; a bf16 output with a bf16
        # and with an f32 bias
        "conv_epilogue": [(y_cl, torch.randn(8, generator=g), True),
                          (y_cl.clone(), torch.randn(8, generator=g), False),
                          (y.clone(), torch.randn(8, generator=g), True),
                          (y.clone(), torch.randn(8, generator=g), False),
                          (y_cl.bfloat16(), torch.randn(8, generator=g).bfloat16(), True),
                          (y_cl.bfloat16(), torch.randn(8, generator=g), False)],
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K14", "conv_epilogue"])
def test_opcheck(kernel):
    """``torch.library.opcheck``: schema, fake implementation (shapes,
    dtypes, strides against the CPU implementation), autograd registration
    and tracing with dynamic shapes."""
    for args in _op_samples()[kernel]:
        torch.library.opcheck(registry.OPS[kernel], args)


def test_ops_count_no_launch_on_the_cpu_or_while_tracing(artifacts):
    """The counters live in the CUDA implementations: neither the CPU path
    nor an export (fake calls) moves them."""
    from mmbidaf_tpu_torch.ops.cuda import (bidaf_kernel, conv_epilogue_kernel, lstm_kernel,
                                            melspec_kernel, winograd_kernel)

    fns = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused, melspec_kernel.mfcc_fused,
           melspec_kernel.log_mel_fused, winograd_kernel.winograd_conv3x3_fused,
           conv_epilogue_kernel.conv_epilogue)
    before = [fn.launches for fn in fns]
    path, summ = artifacts["greedy"]
    export.ExportedDecoder(path, device="cpu").decode_raw(_random_raw(summ.cfg, 4))
    assert [fn.launches for fn in fns] == before


# -- refusals and loader checks ---------------------------------------------------


def test_export_refuses_topk_sp_audio_and_mesh_layouts(weights, tmp_path, capsys):
    """Top-k and ``sp_audio`` are refused as in the JAX package; the mesh
    layouts export (at world size 1 here: ``tests/test_torch_export_mesh.py``
    runs them on gloo groups), and a layout larger than the process group
    fails as the live ``Summarizer`` does."""
    port, _ = weights
    with pytest.raises(ValueError, match="greedy"):
        export.export_summarizer(port(mode="topk", topk=2), str(tmp_path / "never"))
    s = port()
    s.cfg = dataclasses.replace(_cfg(), mesh=dataclasses.replace(_cfg().mesh, sp_audio=True))
    with pytest.raises(ValueError, match="sp_audio"):
        export.export_summarizer(s, str(tmp_path / "never"))
    assert not (tmp_path / "never").exists()
    from mmbidaf_tpu_torch.tools import export_artifact

    with pytest.raises(ValueError, match="2 devices, have 1"):
        export_artifact.main(["--random", "--vgg", "tiny", "--device", "cpu", "--tp_vgg", "1",
                              "--num_model", "2", "--out", str(tmp_path / "never")])
    assert not (tmp_path / "never").exists()
    export_artifact.main(["--random", "--vgg", "tiny", "--device", "cpu", "--data_parallel",
                          "--tp_vgg", "1", "--verify", "--frame_hw", "12x16",
                          "--out", str(tmp_path / "mesh")])
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in out and "verify ok" in out
    m = json.loads((tmp_path / "mesh" / "manifest.json").read_text())
    assert m["format_version"] == 2 and m["head_file"] == "decode.head.pt2"


def test_manifest_contents(artifacts):
    path, summ = artifacts["greedy"]
    m = json.loads(Path(path, "manifest.json").read_text())
    assert set(m["sha256"]) == {"weights.pt", "decode.pt2", "config.json", "vocab.json"}
    assert set(os.listdir(path)) == set(m["sha256"]) | {"manifest.json"}
    assert m["device"] == "cpu" and m["torch_version"] == torch.__version__
    assert m["batch_size"] == B and m["frame_hw"] == list(HW)
    assert m["decode_mode"] == "greedy" and m["beam_width"] is None
    assert m["compute_dtype"] == "float32" and m["vgg_frame_chunk"] == 0
    assert [s["name"] for s in m["raw_inputs"]] == list(export._RAW_KEYS)
    assert m["n_weight_leaves"] == len(m["weight_names"]) == len(m["weight_dtypes"])
    assert "model.word_lstm.fwd.w_h" in m["weight_names"]
    assert "frontend.audio_cos" in m["weight_names"]  # the frontend's constants ride along
    assert m["bucket_programs"] is None and m["mesh"] is None
    beam = json.loads(Path(artifacts["beam"][0], "manifest.json").read_text())
    assert beam["decode_mode"] == "beam" and beam["beam_width"] == 3
    # the weights are stored once, in weights.pt, and not inside the program
    ep = torch.export.load(os.path.join(path, "decode.pt2"))
    assert not ep.state_dict and ep.example_inputs is None
    assert os.path.getsize(os.path.join(path, "decode.pt2")) < 2 * os.path.getsize(
        os.path.join(path, "weights.pt"))


def test_loader_refuses_bad_files_and_devices(artifacts, tmp_path):
    path, _ = artifacts["greedy"]
    bad = tmp_path / "bad"
    shutil.copytree(path, bad)
    with open(bad / "weights.pt", "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="sha256"):
        export.ExportedDecoder(str(bad), device="cpu")
    with pytest.raises(ValueError, match="exported for device 'cpu'.*'cuda'"):
        export.ExportedDecoder(path, device="cuda")
    cuda = tmp_path / "cuda"
    shutil.copytree(path, cuda)
    man = json.loads((cuda / "manifest.json").read_text())
    (cuda / "manifest.json").write_text(json.dumps({**man, "device": "cuda"}))
    with pytest.raises(ValueError, match="exported for device 'cuda'.*'cpu'"):
        export.ExportedDecoder(str(cuda), device="cpu")
    if not torch.cuda.is_available():  # an artifact for the card on a host without one
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.ExportedDecoder(str(cuda), device="cuda")


def test_shape_and_frame_hw_errors(artifacts, tmp_path):
    path, summ = artifacts["greedy"]
    dec = export.ExportedDecoder(path, device="cpu")
    raw = _random_raw(summ.cfg, 5)
    with pytest.raises(ValueError, match="frames"):
        dec.decode_raw({**raw, "frames": raw["frames"][:, :, :8]})
    with pytest.raises(KeyError, match="waveform"):
        dec.decode_raw({k: v for k, v in raw.items() if k != "waveform"})
    rng = np.random.default_rng(0)
    vd = _write_video(tmp_path / "big", rng, summ.cfg, ["Wide frames here.", "Second one."], hw=(24, 32))
    art = export.ExportedSummarizer(path, device="cpu")
    with pytest.raises(ValueError, match="frame_hw"):
        art.summarize(vd)
    with pytest.raises(ValueError, match="frame_hw"):
        art.summarize_long(vd)


# -- serving through the artifact ------------------------------------------------


def _write_video(vd: Path, rng, cfg, sentences, n_frames=2, audio_frac=0.3, hw=HW) -> str:
    from PIL import Image

    d = cfg.data
    (vd / "frames").mkdir(parents=True)
    for i in range(n_frames):
        Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(vd / "frames" / f"f{i}.png")
    n = max(int((d.max_audio_frames * d.hop_length + d.win_length) * audio_frac), 1)
    with wave_mod.open(str(vd / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(d.sample_rate)
        w.writeframes((rng.standard_normal(n) * 8000).astype(np.int16).tobytes())
    (vd / "transcript.txt").write_text(" ".join(sentences))
    return str(vd)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Short videos (one one-word sentence, one frame: the smallest level), one mid-length (the next), one at the caps and one long
    transcript; words from the random vocabulary ("w<i>")."""
    rng = np.random.default_rng(17)
    cfg = _cfg()
    root = tmp_path_factory.mktemp("export_vids")
    short = [_write_video(root / f"short{v}", rng, cfg,
                          [f"W{7 * v % 30}."], n_frames=1, audio_frac=0.1)
             for v in range(3)]
    mid = _write_video(root / "mid", rng, cfg, [f"W{j} w{j + 3} w{j + 9}." for j in range(3)],
                       n_frames=3, audio_frac=0.3)
    full = _write_video(root / "full", rng, cfg,
                        [f"W{j} w{j + 40} w{j + 50} w{j + 60} w{j + 70} w{j + 80}." for j in range(7)],
                        n_frames=6, audio_frac=1.0)
    long_vid = _write_video(root / "long", rng, cfg,
                            [f"W{2 * j} w{2 * j + 1} w{(3 * j) % 40}." for j in range(12)])
    return {"short": short, "mid": mid, "full": full, "long": long_vid}


def test_programs_chosen_smallest_level_first(artifacts, tmp_path):
    """The loader sorts the bucket programs by volume, whatever the
    manifest's order (the manifest is outside the sha256 checks)."""
    path, _ = artifacts["bucketed"]
    dec = export.ExportedDecoder(path, device="cpu")
    vols = [int(np.prod(list(r.values()))) for r in dec.bucket_levels]
    assert len(vols) == 2 and vols == sorted(vols)
    shuffled = tmp_path / "shuffled"
    shutil.copytree(path, shuffled)
    man = json.loads((shuffled / "manifest.json").read_text())
    man["bucket_programs"] = man["bucket_programs"][::-1]
    (shuffled / "manifest.json").write_text(json.dumps(man))
    assert export.ExportedDecoder(str(shuffled), device="cpu").bucket_levels == dec.bucket_levels
    assert set(os.listdir(path)) >= {"decode.b0.pt2", "decode.b1.pt2"}


def test_bucketed_artifact_equals_live_bucketed(artifacts, weights, videos):
    """``summarize_batch`` through the bucketed artifact answers as the live
    bucketed Summarizer does, each level used."""
    path, _ = artifacts["bucketed"]
    port, _ = weights
    art = export.ExportedSummarizer(path, device="cpu")
    live = port(serve_buckets=True, serve_batch_size=B)
    for batch in (videos["short"][:2], [videos["mid"], videos["short"][2]], [videos["full"]]):
        assert art.summarize_batch(batch) == live.summarize_batch(batch)
    d = art.cfg.data
    caps = (d.max_sentences, d.max_words, d.max_keyframes, d.max_audio_frames)
    levels = [tuple(lv[k] for k in ("sentences", "words", "keyframes", "audio_frames"))
              for lv in art.bucket_levels]
    assert set(art.bucket_stats) == set(levels) | {caps}
    assert art.bucket_stats == live.bucket_stats


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_summarize_long_over_the_artifact(artifacts, videos, mode):
    """Windowed serving through the frozen program: equal to the live
    ``summarize_long`` (12 sentences over windows of 7), and a short
    transcript's single window equal to ``summarize``."""
    path, summ = artifacts[mode]
    art = export.ExportedSummarizer(path, device="cpu")
    got = art.summarize_long(videos["long"])
    assert got and got == summ.summarize_long(videos["long"])
    assert art.summarize_long(videos["short"][0]) == art.summarize(videos["short"][0])


def test_dynamic_batcher_over_the_artifact(artifacts, videos):
    """``DynamicBatcher`` coalesces requests over an artifact (its batch is
    fixed) and answers as ``summarize`` does."""
    path, _ = artifacts["bucketed"]
    art = export.ExportedSummarizer(path, device="cpu")
    dirs = videos["short"] + [videos["mid"], videos["full"]]
    want = [art.summarize(v) for v in dirs]
    with pytest.raises(ValueError, match="fixed batch"):
        DynamicBatcher(art, max_batch_size=B + 1)
    out = [None] * len(dirs)
    with DynamicBatcher(art, max_batch_size=B, max_wait_ms=50) as batcher:
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, batcher.submit(dirs[i])))
                   for i in range(len(dirs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert batcher.stats["requests"] == len(dirs)
    assert out == want


# -- the command lines ------------------------------------------------------------


def test_export_cli_random_tiny_verify(tmp_path, capsys):
    from mmbidaf_tpu_torch.tools import export_artifact

    export_artifact.main(["--random", "--vgg", "tiny", "--verify", "--device", "cpu",
                          "--frame_hw", "12x16", "--mode", "beam", "--topk", "2",
                          "--out", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "verify ok: exported picks == live picks (1 program(s))" in out
    assert "device=cpu" in out and "(width 2)" in out
    m = json.loads((tmp_path / "a" / "manifest.json").read_text())
    assert m["decode_mode"] == "beam" and m["beam_width"] == 2
    assert export_artifact.parse_args(["--random", "--out", "x"]).device == "cuda"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port-trained tiny run on a synthetic corpus (``train.cli --data_dir``,
    kernel flags on), exported from its run directory with ``--verify``."""
    from mmbidaf_tpu_torch.tools import export_artifact
    from mmbidaf_tpu_torch.train import cli

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("trained")
    corpus = root / "corpus"
    mod.make_corpus(str(corpus), videos=6, sentences=6, ragged=True, frames=2, seconds=0.5, seed=0,
                    split=2)
    cfg = dataclasses.replace(_cfg(), train=dataclasses.replace(_cfg().train, eval_steps=2))
    (root / "tiny.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    cli.main(["--data_dir", str(corpus), "--vgg", "tiny", "--config_json", str(root / "tiny.json"),
              "--device", "cpu", "--save_dir", str(root), "--name", "run", "--num_steps", "2"])
    export_artifact.main(["--run_dir", str(root / "run"), "--out", str(root / "art"), "--batch", "2",
                          "--frame_hw", "48x64", "--device", "cpu", "--verify"])
    return {"corpus": str(corpus), "run": str(root / "run"), "art": str(root / "art")}


def test_export_cli_from_a_trained_run(trained):
    """The artifact serves the run as ``Summarizer.from_run`` does."""
    art = export.ExportedSummarizer(trained["art"], device="cpu")
    seed = json.loads(Path(trained["run"], "config.json").read_text())["train"]["seed"]
    live = Summarizer.from_run(trained["run"], seed=seed, device="cpu")
    dev = sorted(str(p) for p in Path(trained["corpus"], "dev").iterdir())
    assert art.summarize_batch(dev) == live.summarize_batch(dev)


def test_infer_artifact(trained, capsys):
    from mmbidaf_tpu_torch import infer

    infer.main(["--artifact", trained["art"], "--data_dir", trained["corpus"], "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "artifact decode_mode=greedy batch=2"
    scores = eval(lines[-1].split(" (")[0])  # the printed dict
    assert "(2 videos scored)" in lines[-1]
    assert all(math.isfinite(v) for v in scores.values())
    for flags, msg in (([], "pass --data_dir"),
                       (["--data_dir", trained["corpus"], "--mode", "beam"], "--mode is fixed"),
                       (["--data_dir", trained["corpus"], "--load_dir", "x"], "--load_dir is fixed"),
                       (["--data_dir", trained["corpus"], "--vgg", "tiny"], "--vgg is fixed"),
                       (["--data_dir", trained["corpus"], "--bucket_eval"], "--bucket_eval is fixed")):
        with pytest.raises(SystemExit, match=msg):
            infer.main(["--artifact", trained["art"], "--device", "cpu", *flags])


def _req(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if payload is None else json.dumps(payload))
    resp = conn.getresponse()
    body = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, body


def test_serve_daemon_over_the_artifact(artifacts, videos, capsys):
    """``tools/serve.py --artifact`` in a subprocess with ``--warmup`` and a
    batcher at the artifact's batch: its answers equal
    ``ExportedSummarizer.summarize``'s, ``/healthz`` shows the artifact's
    format and bucket counts, and SIGTERM drains it; the flags fixed at
    export are refused before the load."""
    from mmbidaf_tpu_torch.tools import serve as serve_tool

    path, _ = artifacts["bucketed"]
    for flags, msg in ((["--mode", "beam"], "--mode is fixed"),
                       (["--serve_batch_size", "2"], "--serve_batch_size is fixed"),
                       (["--bucket_serving"], "--bucket_serving is fixed"),
                       (["--dynamic_batch", "4"], "--dynamic_batch 4 != the artifact's batch 2"),
                       (["--warmup", "24x32"], "--warmup 24x32 != the artifact's frame_hw")):
        with pytest.raises(SystemExit):
            serve_tool.main(["--artifact", path, "--device", "cpu", *flags])
        assert msg in capsys.readouterr().err
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    p = subprocess.Popen([sys.executable, "-u", "-m", "mmbidaf_tpu_torch.tools.serve",
                          "--artifact", path, "--device", "cpu", "--port", "0", "--warmup", "12x16",
                          "--dynamic_batch", "2"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        lines = []
        for line in p.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving "), "".join(lines) + p.stderr.read()
        assert any(ln.startswith("warmup:") for ln in lines)
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        art = export.ExportedSummarizer(path, device="cpu")
        for vd in (videos["short"][0], videos["full"]):
            status, out = _req(port, "POST", "/summarize", {"video_dir": vd})
            assert status == 200 and out["summary"] == art.summarize(vd)
        status, health = _req(port, "GET", "/healthz")
        assert status == 200 and health["decode_mode"] == "greedy"
        assert health["artifact"]["format_version"] == 1 and health["artifact"]["batch_size"] == 2
        assert health["artifact"]["bucket_programs"] == 2 and health["batcher"]["requests"] == 2
        assert sum(health["buckets"].values()) == 2
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stdout.close()
        p.stderr.close()
