"""The port's CLIs under a mesh, on a gloo group of 2 processes on the CPU:
``tools/export_artifact.py --data_parallel --verify``, ``infer --artifact``
and the HTTP daemon (``tools/serve.py --data_parallel``) over a live run
and over the exported data-parallel artifact.

Two processes run this file as a script (``python
tests/test_torch_serve_mesh.py script PLAN``, torch and the port only),
each with ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` as a
user's launcher sets them, a fresh ``FileStore`` for each CLI, and runs the
plan's CLIs in order through their ``main``. For each daemon the test waits
for rank 0's ``serving ... on http://`` line, sends its requests, then
SIGTERM to rank 0 alone; both ranks must finish the CLI, and the group
must exit 0, inside the fixture's time limit. Rank 0 of the script stands
in for a full batcher queue on requests for a directory named
``overload*`` (``DynamicBatcher.submit`` raises ``ServerOverloadedError``
there, where the real check sits, before any host decode). Every answer
must equal the single-process ``Summarizer``'s; a 400 and a 503 must leave
the next request answered.
"""

from __future__ import annotations

import dataclasses
import http.client
import importlib
import json
import os
import signal
import sys
import threading
import time
import wave as wave_mod
from pathlib import Path

import numpy as np
import torch_group

HW = (10, 12)
TIME_LIMIT = 240.0


def run_script(plan_path: str) -> None:
    """The worker side: each ``(module, argv, store)`` of the plan in turn."""
    from mmbidaf_tpu_torch.serving import DynamicBatcher, ServerOverloadedError

    submit = DynamicBatcher.submit

    def submit_or_shed(self, video_dir: str) -> str:
        if os.path.basename(video_dir).startswith("overload"):
            raise ServerOverloadedError("pending-request queue at max_queue; retry later")
        return submit(self, video_dir)

    DynamicBatcher.submit = submit_or_shed
    with open(plan_path) as f:
        steps = json.load(f)
    for i, (module, argv, store) in enumerate(steps):
        os.environ["COORDINATOR_ADDRESS"] = f"file://{store}"
        importlib.import_module(module).main(argv)
        print(f"step {i} done", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "script":
        sys.path.insert(0, torch_group.REPO)
        run_script(sys.argv[2])
        sys.exit(0)
    raise SystemExit("usage: test_torch_serve_mesh.py script PLAN")


import pytest  # noqa: E402

from mmbidaf_tpu_torch.config import tiny_test_config  # noqa: E402
from mmbidaf_tpu_torch.serving import Summarizer  # noqa: E402


def _cfg():
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True, vgg_variant="tiny"))


def _write_video(vd: Path, rng, cfg, transcript: str, poison: bool = False) -> str:
    from PIL import Image

    (vd / "frames").mkdir(parents=True)
    if poison:
        (vd / "frames" / "f0.png").write_bytes(b"not a png")
    else:
        for j in range(2):
            Image.fromarray((rng.random((*HW, 3)) * 255).astype(np.uint8)).save(
                vd / "frames" / f"f{j}.png")
    d = cfg.data
    n = (d.max_audio_frames * d.hop_length + d.win_length) // 3
    with wave_mod.open(str(vd / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(d.sample_rate)
        w.writeframes((rng.standard_normal(n) * 8000).astype(np.int16).tobytes())
    (vd / "transcript.txt").write_text(transcript)
    (vd / "summary.txt").write_text(transcript.split(". ")[0] + ".")
    return str(vd)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A train.cli-shaped run directory, a corpus of three videos, a
    poisoned video and one the daemon's rank 0 sheds."""
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.data.vocab import save_vocab
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager, save_config
    from mmbidaf_tpu_torch.train.loop import init_train_state

    cfg = _cfg()
    root = tmp_path_factory.mktemp("serve_mesh")
    run = root / "run"
    w2i = {f"w{i}": i for i in range(cfg.data.vocab_size)}
    w2i.update({w: i + 2 for i, w in enumerate(("the", "video", "point", "ends"))})
    wv = random_word_vectors(np.random.default_rng(0), cfg.data.vocab_size, cfg.model.emb_dim)
    run.mkdir()
    save_vocab(w2i, wv, str(run / "vocab.json"), str(run / "emb.npz"))
    CheckpointManager(run / "ckpts").save_unranked(
        init_train_state(mmbidaf_init(cfg, wv, "cpu", seed=0), cfg, seed=1))
    save_config(run, cfg)
    rng = np.random.default_rng(0)
    good = [_write_video(root / "corpus" / f"v{i}", rng, cfg, " ".join(
        f"The video {i} makes point {j}." for j in range(3 + 2 * i)) + " It ends.")
        for i in range(3)]
    bad = _write_video(root / "bad", rng, cfg, "Never read.", poison=True)
    overload = _write_video(root / "overload", rng, cfg, "Shed before decode.")
    return {"root": root, "run": str(run), "corpus": str(root / "corpus"), "good": good,
            "bad": bad, "overload": overload}


def _req(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if payload is None else json.dumps(payload))
    resp = conn.getresponse()
    out = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, out


def _wait_for(log_path: str, text: str, count: int, deadline: float, procs) -> str:
    """Rank 0's log once it holds ``count`` lines starting with ``text``."""
    while time.monotonic() < deadline:
        with open(log_path) as f:
            log = f.read()
        if sum(ln.startswith(text) for ln in log.splitlines()) >= count:
            return log
        if any(p.poll() is not None for p in procs):
            raise AssertionError(f"a rank exited early:\n{log[-3000:]}")
        time.sleep(0.2)
    raise AssertionError(f"no {text!r} line #{count} in time:\n{log[-3000:]}")


def _daemon_requests(port: int, s: dict) -> dict:
    """The requests sent to one daemon; their statuses and answers."""
    out = {"healthz": _req(port, "GET", "/healthz")}
    out["one"] = _req(port, "POST", "/summarize", {"video_dir": s["good"][0]})
    answers = [None] * len(s["good"])

    def ask(i):
        answers[i] = _req(port, "POST", "/summarize", {"video_dir": s["good"][i]})

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(s["good"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["concurrent"] = answers
    out["batch"] = _req(port, "POST", "/summarize_batch", {"video_dirs": s["good"]})
    out["bad"] = _req(port, "POST", "/summarize", {"video_dir": s["bad"]})
    out["overload"] = _req(port, "POST", "/summarize", {"video_dir": s["overload"]})
    out["after"] = _req(port, "POST", "/summarize", {"video_dir": s["good"][1]})
    out["healthz_after"] = _req(port, "GET", "/healthz")
    return out


@pytest.fixture(scope="module")
def group(setup):
    """The plan's CLIs in one group of 2: the export, infer, then the
    daemon over the live run and over the artifact."""
    root, art = setup["root"], str(setup["root"] / "artifact")
    daemon = ["--device", "cpu", "--port", "0", "--dynamic_batch", "2", "--max_queue", "8"]
    steps = [
        ("mmbidaf_tpu_torch.tools.export_artifact",
         ["--run_dir", setup["run"], "--out", art, "--batch", "2", "--frame_hw", "x".join(map(
             str, HW)), "--data_parallel", "--verify", "--device", "cpu"]),
        ("mmbidaf_tpu_torch.infer", ["--artifact", art, "--data_dir", setup["corpus"],
                                     "--device", "cpu"]),
        ("mmbidaf_tpu_torch.tools.serve", ["--run_dir", setup["run"], "--data_parallel",
                                           "--serve_batch_size", "2", "--warmup", "10x12",
                                           *daemon]),
        ("mmbidaf_tpu_torch.tools.serve", ["--artifact", art, "--data_parallel", *daemon]),
    ]
    plan = [(m, argv, str(root / f"store{i}")) for i, (m, argv) in enumerate(steps)]
    plan_path = str(root / "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    script = os.path.abspath(__file__)
    procs, logs = torch_group.start([[script, "script", plan_path]] * 2, str(root), [
        {"NUM_PROCESSES": "2", "PROCESS_ID": str(r)} for r in range(2)])
    log0 = str(root / "r0.log")
    deadline = time.monotonic() + TIME_LIMIT
    answers = {}
    try:
        for k, name in ((1, "live"), (2, "artifact")):
            log = _wait_for(log0, "serving ", k, deadline, procs)
            port = int(log.split("http://127.0.0.1:")[k].split()[0])
            answers[name] = _daemon_requests(port, setup)
            procs[0].send_signal(signal.SIGTERM)
            _wait_for(log0, f"step {k + 1} done", 1, deadline, procs[:0])
        texts = torch_group.finish(procs, logs, deadline, "the CLIs' group of 2")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return answers, texts, [p.returncode for p in procs]


def _reference(setup, seed):
    s = Summarizer.from_run(setup["run"], seed=seed, device="cpu")
    return {v: s.summarize(v) for v in setup["good"]}


def test_export_cli_and_infer_under_the_group(group, setup):
    """``export_artifact --data_parallel --verify`` under the group: rank 0
    writes a 2-rank artifact, every rank verifies it; ``infer --artifact``
    scores the corpus alike on both ranks, as one process scores it."""
    import contextlib
    import io

    from mmbidaf_tpu_torch.data.pipeline import VideoCorpus
    from mmbidaf_tpu_torch.infer import summarizer_corpus_eval

    _, texts, rcs = group
    assert rcs == [0, 0]
    assert "mesh={'data': 2}" in texts[0]
    for r, text in enumerate(texts):
        assert f"verify ok: exported picks == live picks (1 program(s)) on rank {r}" in text
    manifest = json.loads((setup["root"] / "artifact" / "manifest.json").read_text())
    assert manifest["mesh"]["batch_axes"] == ["data"] and manifest["batch_size"] == 2
    scores = [[ln for ln in t.splitlines() if "videos scored" in ln] for t in texts]
    assert len(scores[0]) == 1 and scores[0] == scores[1]
    s = Summarizer.from_run(setup["run"], seed=_cfg().train.seed, device="cpu",
                            serve_batch_size=2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summarizer_corpus_eval(s, VideoCorpus(setup["corpus"], s.cfg, s.word2idx,
                                              use_precomputed=False), False, False)
    assert scores[0][0] == buf.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("name", ["live", "artifact"])
def test_daemon_answers_as_one_process(name, group, setup):
    """Through the batcher (one and concurrent ``/summarize``) and through
    the handler (``/summarize_batch``), every answer is the single-process
    summary; ``/healthz`` shows the mesh."""
    answers = group[0][name]
    # the daemon serves a run's frontend from seed 0; the export, from the run's seed
    want = _reference(setup, 0 if name == "live" else _cfg().train.seed)
    good = setup["good"]
    assert answers["one"] == (200, {"summary": want[good[0]]})
    assert answers["concurrent"] == [(200, {"summary": want[v]}) for v in good]
    assert answers["batch"] == (200, {"summaries": [want[v] for v in good]})
    status, health = answers["healthz"]
    assert status == 200
    if name == "live":
        assert health["parallelism"] == {"mesh_axes": {"data": 2}, "dp_shards": 2,
                                         "sp_audio": False, "tp_vgg": False}
    else:
        assert health["parallelism"] == {"mesh_axes": {"data": 2}, "artifact_format": 2}


@pytest.mark.parametrize("name", ["live", "artifact"])
def test_bad_requests_and_overload_stall_no_rank(name, group, setup):
    """A bad asset (400) and a shed request (503) are answered on rank 0
    without a device call; the next request is answered, and a stop of rank
    0 ends both ranks with exit 0, rank 1 after the calls rank 0 sent."""
    answers, texts, rcs = group
    a = answers[name]
    want = _reference(setup, 0 if name == "live" else _cfg().train.seed)
    assert a["bad"][0] == 400 and a["bad"][1]["kind"] == "bad_asset"
    assert a["overload"][0] == 503 and a["overload"][1]["kind"] == "overloaded"
    assert a["after"] == (200, {"summary": want[setup["good"][1]]})
    assert a["healthz_after"][1]["latency"]["/summarize"]["errors"] == 2
    assert rcs == [0, 0]
    followed = [ln for ln in texts[1].splitlines() if ln.startswith("rank 1: ran ")]
    assert len(followed) == 2 and all(int(ln.split()[3]) > 0 for ln in followed)
