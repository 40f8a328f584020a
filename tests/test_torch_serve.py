"""The port's HTTP daemon (``tools/serve.py``), its load test
(``tools/load_test.py``) and ``tools/suggest_buckets.py``, on the CPU.

The daemon's cases mirror the JAX package's ``tests/test_serve_daemon.py``:
the endpoints answer as the library does, a bad asset gets a 400 and the
server keeps serving, ``/healthz`` reports latency, bucket counts and the
batcher. The load test's ``--tiny`` sweep runs all five configurations,
every request answered with the library's summary. The daemon also runs
as a user runs it, in a subprocess from a run directory with ``--warmup``,
and drains on SIGTERM.
"""

import dataclasses
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import wave as wave_mod
from pathlib import Path

import numpy as np
import pytest

from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
from mmbidaf_tpu_torch.serving import Summarizer
from mmbidaf_tpu_torch.tools import load_test
from mmbidaf_tpu_torch.tools import serve as serve_tool

REPO = Path(__file__).resolve().parents[1]


def _cfg():
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))


def _write_video(vd: Path, rng, cfg, transcript: str, poison: bool = False, audio_frac=1 / 3):
    from PIL import Image

    (vd / "frames").mkdir(parents=True)
    if poison:
        (vd / "frames" / "f0.png").write_bytes(b"not a png")
    else:
        Image.fromarray((rng.random((10, 12, 3)) * 255).astype(np.uint8)).save(vd / "frames" / "f0.png")
    d = cfg.data
    n = int((d.max_audio_frames * d.hop_length + d.win_length) * audio_frac)
    with wave_mod.open(str(vd / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(d.sample_rate)
        w.writeframes((rng.standard_normal(n) * 8000).astype(np.int16).tobytes())
    (vd / "transcript.txt").write_text(transcript)
    return str(vd)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    rng = np.random.default_rng(0)
    cfg = _cfg()
    s = Summarizer.init_random(cfg, seed=0, vgg_spec=TINY_SPEC, device="cpu", serve_buckets=True)
    srv = serve_tool.serve(s, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    root = tmp_path_factory.mktemp("vids")
    dirs = {name: _write_video(root / name, rng, cfg,
                               f"The {name} video starts. It continues here. It ends now.",
                               poison=name == "bad") for name in ("good", "bad")}
    dirs["long"] = _write_video(root / "long", rng, cfg, " ".join(
        f"Long sentence {j} covers point {j}." for j in range(3 * cfg.data.max_sentences)),
        audio_frac=0.25)
    yield srv.server_address[1], dirs, s
    srv.shutdown()
    srv.server_close()


def _req(port, method, path, payload=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=json.dumps(payload) if payload is not None else None)
    resp = conn.getresponse()
    out = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, out


def test_healthz(server):
    port, dirs, _ = server
    _req(port, "POST", "/summarize", {"video_dir": dirs["good"]})
    status, out = _req(port, "GET", "/healthz")
    assert status == 200 and out["ok"] is True
    assert out["backend"] == "cpu" and out["decode_mode"] == "greedy"
    assert "batcher" not in out  # no batcher on this daemon
    assert out["buckets"] and all(len(k.split("x")) == 4 for k in out["buckets"])
    lat = out["latency"]["/summarize"]
    assert lat["count"] >= 1 and 0 < lat["p50_ms"] <= lat["p95_ms"]


def test_summarize_roundtrip(server):
    port, dirs, s = server
    status, out = _req(port, "POST", "/summarize", {"video_dir": dirs["good"]})
    assert status == 200 and out["summary"] == s.summarize(dirs["good"])
    assert "video" in out["summary"]


def test_summarize_batch(server):
    port, dirs, _ = server
    status, out = _req(port, "POST", "/summarize_batch", {"video_dirs": [dirs["good"], dirs["good"]]})
    assert status == 200 and len(out["summaries"]) == 2
    assert out["summaries"][0] == out["summaries"][1]


def test_poisoned_request_returns_400_and_server_survives(server):
    port, dirs, _ = server
    status, out = _req(port, "POST", "/summarize", {"video_dir": dirs["bad"]})
    assert status == 400 and out["kind"] == "bad_asset"
    status, out = _req(port, "POST", "/summarize", {"video_dir": dirs["good"]})
    assert status == 200 and out["summary"]


def test_server_fault_is_a_500(server, monkeypatch):
    """A device fault answers 500, never a summary, and the daemon serves on."""
    port, dirs, s = server

    def fault(raw, generator=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(s, "_decode_batch_device", fault)
    status, out = _req(port, "POST", "/summarize", {"video_dir": dirs["good"]})
    assert status == 500 and out["kind"] == "server_error" and "summary" not in out
    monkeypatch.undo()
    assert _req(port, "POST", "/summarize", {"video_dir": dirs["good"]})[0] == 200


def test_long_mode_server(server):
    port, dirs, s = server
    srv = serve_tool.serve(s, port=0, use_long=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        status, out = _req(srv.server_address[1], "POST", "/summarize", {"video_dir": dirs["long"]})
        assert status == 200 and out["summary"] == s.summarize_long(dirs["long"])
    finally:
        srv.shutdown()
        srv.server_close()


def test_bad_payloads(server):
    port, _, _ = server
    assert _req(port, "POST", "/summarize", {"wrong_field": 1})[0] == 400
    assert _req(port, "POST", "/summarize_batch", {"video_dir": "x"})[0] == 400
    assert _req(port, "POST", "/nope", {})[0] == 404
    assert _req(port, "GET", "/nope")[0] == 404


def test_latency_stats_percentiles():
    st = serve_tool.LatencyStats()
    st.record("/x", 0.010, ok=True)
    st.record("/x", 0.100, ok=False)
    snap = st.snapshot()["/x"]
    assert snap["count"] == 2 and snap["errors"] == 1
    assert snap["p50_ms"] == 10.0 and snap["p95_ms"] == 100.0
    for ms in (20, 30, 40, 50):
        st.record("/x", ms / 1e3, ok=True)
    snap = st.snapshot()["/x"]
    assert snap["p50_ms"] == 30.0 and snap["p95_ms"] == 100.0


# -- the load test -----------------------------------------------------------------


@pytest.fixture(scope="module")
def load_setup(tmp_path_factory):
    cfg = _cfg()
    dirs = load_test.make_mixed_corpus(str(tmp_path_factory.mktemp("load_corpus")), cfg,
                                       per_tier=1, res=(12, 16), seed=3)
    plain = Summarizer.init_random(cfg, seed=0, vgg_spec=TINY_SPEC, device="cpu")
    summarizers = {False: plain, True: Summarizer(plain.model, plain.frontend, plain.word2idx,
                                                  cfg, TINY_SPEC, serve_buckets=True)}
    return summarizers, dirs


def test_mixed_corpus_tiers(load_setup):
    _, dirs = load_setup
    assert set(dirs) == {"quarter", "half", "full"}
    n_frames = {t: len(os.listdir(os.path.join(d[0], "frames"))) for t, d in dirs.items()}
    assert n_frames["quarter"] < n_frames["full"]


def test_tiny_sweep_over_all_configs(load_setup):
    """Every configuration answers every request with the library's summary;
    percentiles are ordered; the batchers coalesce and the bucketed ones
    count rung tuples."""
    summarizers, dirs = load_setup
    expected = {vd: summarizers[False].summarize(vd) for ds in dirs.values() for vd in ds}
    rows = load_test.run_sweep(lambda buckets: summarizers[buckets], dirs, clients=3, requests=9,
                               dynamic_batch=4, batch_wait_ms=20.0, http_timeout=120.0)
    assert [r["config"] for r in rows] == list(load_test.CONFIGS)
    for r in rows:
        assert r["ok"] == 9 and r["errors"] == 0
        lm = r["latency_ms"]
        assert lm["p50"] <= lm["p95"] <= lm["p99"] < 60_000
        assert r["sustained_vps"] > 0
        assert set(r["per_tier_p50_ms"]) == {"quarter", "half", "full"}
        assert all(answers == [expected[vd]] for vd, answers in r["answers"].items())
        if r["config"] == "seq":
            assert "batcher" not in r
        else:
            b = r["batcher"]
            assert b["requests"] == 12 and 0 < b["batches"] <= 12  # 3 first requests + 9
    assert len(summarizers[True].bucket_stats) >= 1
    assert rows[-1]["batcher"]["bucket_splits"] == 0  # bucket_nogroup never splits


def test_percentile_nearest_rank():
    xs = [float(i) for i in range(1, 101)]
    assert load_test.percentile(xs, 50) == 50.0
    assert load_test.percentile(xs, 95) == 95.0
    assert load_test.percentile(xs, 99) == 99.0
    assert load_test.percentile([7.0], 99) == 7.0
    assert np.isnan(load_test.percentile([], 50))


def test_load_test_cli_tiny(tmp_path):
    out = tmp_path / "load.json"
    load_test.main(["--tiny", "--device", "cpu", "--requests", "4", "--clients", "2",
                    "--per_tier", "1", "--res", "12x16", "--configs", "seq,batch",
                    "--dynamic_batch", "2", "--out", str(out)])
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and [r["config"] for r in report["configs"]] == ["seq", "batch"]
    assert all(r["ok"] == 4 for r in report["configs"])


# -- the daemon's command line -------------------------------------------------------


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A train.cli-shaped run directory: config, vocabulary, a checkpoint."""
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.data.vocab import save_vocab
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager, save_config
    from mmbidaf_tpu_torch.train.loop import init_train_state

    cfg = dataclasses.replace(_cfg(), model=dataclasses.replace(_cfg().model, vgg_variant="tiny"))
    root = tmp_path_factory.mktemp("serve_run")
    w2i = {f"w{i}": i for i in range(cfg.data.vocab_size)}
    wv = random_word_vectors(np.random.default_rng(0), cfg.data.vocab_size, cfg.model.emb_dim)
    save_vocab(w2i, wv, str(root / "vocab.json"), str(root / "emb.npz"))
    state = init_train_state(mmbidaf_init(cfg, wv, "cpu", seed=0), cfg, seed=1)
    CheckpointManager(root / "ckpts").save_unranked(state)
    save_config(root, cfg)
    return str(root)


def test_daemon_process_warms_serves_and_drains(run_dir, server):
    """``python -m mmbidaf_tpu_torch.tools.serve`` with --warmup and a batcher:
    it warms before it listens, answers as ``Summarizer.from_run`` does,
    and exits 0 on SIGTERM."""
    _, dirs, _ = server
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    p = subprocess.Popen([sys.executable, "-u", "-m", "mmbidaf_tpu_torch.tools.serve",
                          "--run_dir", run_dir, "--device", "cpu", "--port", "0",
                          "--warmup", "10x12", "--dynamic_batch", "2", "--bucket_serving",
                          "--mode", "beam", "--topk", "2"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        lines = []
        deadline = time.time() + 120
        while time.time() < deadline:
            line = p.stdout.readline()
            lines.append(line)
            if line.startswith("serving ") or not line:
                break
        assert lines[-1].startswith("serving "), "".join(lines) + p.stderr.read()
        assert any(ln.startswith("warmup:") for ln in lines)
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        status, out = _req(port, "POST", "/summarize", {"video_dir": dirs["good"]})
        want = Summarizer.from_run(run_dir, mode="beam", topk=2, device="cpu").summarize(dirs["good"])
        assert status == 200 and out["summary"] == want
        status, health = _req(port, "GET", "/healthz")
        assert health["decode_mode"] == "beam" and health["batcher"]["requests"] == 1
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stdout.close()
        p.stderr.close()


def test_daemon_flags_checked_before_the_load(run_dir, tmp_path, capsys):
    # the mesh flags (tests/test_torch_serve_mesh.py serves under a group)
    for flags, msg in ((["--data_parallel"], "pass --serve_batch_size"),
                       (["--tp_vgg", "1", "--num_model", "2"], "the process group has 1"),
                       (["--num_model", "0"], "--num_model must be >= 1")):
        with pytest.raises(SystemExit):
            serve_tool.main(["--run_dir", run_dir, "--device", "cpu", *flags])
        assert msg in capsys.readouterr().err
    # an artifact fixes its decode mode, batch and levels at export
    for flags, name in ((["--mode", "beam"], "--mode"), (["--serve_batch_size", "2"], "--serve_batch_size"),
                        (["--bucket_serving"], "--bucket_serving")):
        with pytest.raises(SystemExit):
            serve_tool.main(["--artifact", "x", *flags])
        assert f"{name} is fixed at export time" in capsys.readouterr().err
    bad = tmp_path / "ladders.json"
    bad.write_text(json.dumps({"frames": [2]}))
    for flags, msg in ((["--bucket_serving", "--bucket_ladders", str(bad)], "unknown serve_buckets"),
                       (["--bucket_ladders", str(bad)], "pass both"),
                       (["--warmup", "240"], "HxW"),
                       (["--dynamic_batch", "4", "--long"], "pick one")):
        with pytest.raises(SystemExit):
            serve_tool.main(["--run_dir", run_dir, "--device", "cpu", *flags])
        assert msg in capsys.readouterr().err
    assert serve_tool.parse_args(["--run_dir", "x"])[1].device == "cuda"
    assert load_test.CONFIGS == ("seq", "batch", "batch_sync", "bucket_group", "bucket_nogroup")


def test_suggest_buckets_matches_the_reference_tool(tmp_path, capsys):
    """The port's tool prints the JSON of the repository's tool on one corpus."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_corpus(str(tmp_path / "c"), videos=6, sentences=10, ragged=True, frames=3,
                    seconds=0.5, seed=2, split=2)
    cfg_json = str(REPO / "examples" / "tiny_config.json")
    from mmbidaf_tpu_torch.tools import suggest_buckets

    suggest_buckets.main(["--data_dir", str(tmp_path / "c"), "--config_json", cfg_json,
                          "--quantiles", "0.5,1.0"])
    ours = json.loads(capsys.readouterr().out)
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "tools/suggest_buckets.py", "--data_dir", str(tmp_path / "c"),
                        "--config_json", cfg_json, "--quantiles", "0.5,1.0"],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert ours == json.loads(r.stdout)
    assert set(ours) == {"sentences", "words", "keyframes", "audio_frames"}
