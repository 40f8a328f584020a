"""The port's ``DynamicBatcher``, case for case as the JAX package's
``tests/test_dynamic_batch.py``: concurrent requests coalesce into one
device batch, answers equal the sequential library path, failures stay
scoped (a bad asset fails its request, a batch error its batch, a fetch
error its batch and not the completion thread), load is shed before any
host decode, and close drains. Then the bucket cases of the JAX package's
``tests/test_bucket_serving.py``: the batcher trims, and groups a mixed set
by covering rung level unless told not to.
"""

import dataclasses
import http.client
import json
import threading
import time
import wave as wave_mod
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest

from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
from mmbidaf_tpu_torch.serving import DynamicBatcher, ServerOverloadedError, Summarizer


def _cfg():
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))


def _write_video(vd, rng, cfg, sents, n_frames=3, audio_frac=1 / 3):
    from PIL import Image

    d = cfg.data
    (vd / "frames").mkdir(parents=True)
    for i in range(n_frames):
        Image.fromarray((rng.random((12, 16, 3)) * 255).astype(np.uint8)).save(vd / "frames" / f"f{i}.png")
    n = int((d.max_audio_frames * d.hop_length + d.win_length) * audio_frac)
    with wave_mod.open(str(vd / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(d.sample_rate)
        w.writeframes((rng.standard_normal(n) * 8000).astype(np.int16).tobytes())
    (vd / "transcript.txt").write_text(" ".join(sents))
    return str(vd)


@pytest.fixture(scope="module")
def serving_setup(tmp_path_factory):
    """One tiny Summarizer, 3 distinct good videos and 1 poisoned video."""
    rng = np.random.default_rng(7)
    cfg = _cfg()
    root = tmp_path_factory.mktemp("dynbatch_vids")
    dirs = [_write_video(root / f"vid{v}", rng, cfg,
                         [f"Video {v} sentence {j} covers topic {v}{j}." for j in range(5)])
            for v in range(3)]
    bad = root / "bad"
    (bad / "frames").mkdir(parents=True)
    (bad / "frames" / "f0.png").write_bytes(b"not a png")
    (bad / "transcript.txt").write_text("Bad video sentence.")
    s = Summarizer.init_random(cfg, seed=0, vgg_spec=TINY_SPEC, device="cpu")
    return s, dirs, str(bad)


def test_coalesces_and_matches_sequential(serving_setup):
    s, dirs, _ = serving_setup
    expected = {vd: s.summarize(vd) for vd in dirs}
    assert len(set(expected.values())) == 3  # a row/future mix-up would show
    reqs = [dirs[i % 3] for i in range(6)]
    barrier = threading.Barrier(len(reqs))

    def call(vd):
        barrier.wait()
        return batcher.submit(vd)

    with DynamicBatcher(s, max_batch_size=4, max_wait_ms=300.0) as batcher:
        with ThreadPoolExecutor(max_workers=len(reqs)) as ex:
            outs = list(ex.map(call, reqs))
    assert outs == [expected[vd] for vd in reqs]
    assert batcher.stats["requests"] == 6
    assert 2 <= batcher.stats["batches"] <= 3
    assert batcher.stats["padded_rows"] == 4 * batcher.stats["batches"] - 6


def test_single_request_pads_to_static_shape(serving_setup):
    s, dirs, _ = serving_setup
    with DynamicBatcher(s, max_batch_size=4, max_wait_ms=1.0) as batcher:
        out = batcher.submit(dirs[0])
    assert out == s.summarize(dirs[0])
    assert batcher.stats == {"requests": 1, "batches": 1, "padded_rows": 3,
                             "rejected": 0, "bucket_splits": 0}


def test_bad_asset_fails_only_its_request(serving_setup):
    s, dirs, bad = serving_setup
    barrier = threading.Barrier(2)

    def call(vd):
        barrier.wait()
        return batcher.submit(vd)

    with DynamicBatcher(s, max_batch_size=4, max_wait_ms=200.0) as batcher:
        with ThreadPoolExecutor(max_workers=2) as ex:
            good_f = ex.submit(call, dirs[0])
            bad_f = ex.submit(call, bad)
            with pytest.raises((OSError, ValueError)):
                bad_f.result(timeout=60)
            assert good_f.result(timeout=60) == s.summarize(dirs[0])


def test_close_rejects_new_and_drains_queued(serving_setup):
    s, dirs, _ = serving_setup
    batcher = DynamicBatcher(s, max_batch_size=2, max_wait_ms=1.0)
    assert batcher.submit(dirs[0]) == s.summarize(dirs[0])
    batcher.close()
    with pytest.raises(RuntimeError):
        batcher.submit(dirs[0])
    batcher.close()  # idempotent
    assert not batcher._thread.is_alive() and not batcher._completer.is_alive()


def _req(port, method, path, payload=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=json.dumps(payload) if payload is not None else None)
    resp = conn.getresponse()
    out = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, out


def test_daemon_dynamic_batch_path(serving_setup):
    """The daemon with a batcher: concurrent POSTs all answer as the library
    does, a poisoned one gets a 400, and /healthz reports the coalescing."""
    from mmbidaf_tpu_torch.tools.serve import serve

    s, dirs, bad = serving_setup
    expected = {vd: s.summarize(vd) for vd in dirs}
    batcher = DynamicBatcher(s, max_batch_size=4, max_wait_ms=200.0)
    srv = serve(s, port=0, batcher=batcher)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    try:
        reqs = [dirs[i % 3] for i in range(5)] + [bad]
        barrier = threading.Barrier(len(reqs))

        def post(vd):
            barrier.wait()
            return _req(port, "POST", "/summarize", {"video_dir": vd})

        with ThreadPoolExecutor(max_workers=len(reqs)) as ex:
            results = list(ex.map(post, reqs))
        for vd, (status, out) in zip(reqs[:5], results[:5]):
            assert status == 200 and out["summary"] == expected[vd]
        status, out = results[5]
        assert status == 400 and out.get("kind") == "bad_asset"
        status, health = _req(port, "GET", "/healthz")
        assert status == 200 and health["batcher"]["requests"] >= 5
        assert health["batcher"]["batches"] < health["batcher"]["requests"]
        lat = health["latency"]["/summarize"]
        assert lat["count"] == 6 and lat["errors"] == 1
        assert 0 < lat["p50_ms"] <= lat["p95_ms"]
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()


def test_batch_assembly_error_fails_batch_not_thread(serving_setup):
    s, dirs, _ = serving_setup
    with DynamicBatcher(s, max_batch_size=4, max_wait_ms=5.0) as b:
        row0, sents0 = s._raw_row(dirs[0])
        row1, sents1 = s._raw_row(dirs[1])
        row1 = dict(row1)
        row1["frames"] = row1["frames"][:, :-1]  # mismatched resolution
        items = [(row0, sents0, Future()), (row1, sents1, Future())]
        b._run_batch(items)
        for _, _, fut in items:
            with pytest.raises(ValueError):
                fut.result(timeout=5)
        assert b.submit(dirs[0]) == s.summarize(dirs[0])


def test_submit_racing_close_raises_not_hangs(serving_setup, monkeypatch):
    s, dirs, _ = serving_setup
    b = DynamicBatcher(s, max_batch_size=2, max_wait_ms=5.0)
    real_raw = s._raw_row
    started, release = threading.Event(), threading.Event()

    def slow_raw(video_dir):
        started.set()
        assert release.wait(30)
        return real_raw(video_dir)

    monkeypatch.setattr(s, "_raw_row", slow_raw)
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(b.submit, dirs[0])
        assert started.wait(30)
        b.close()  # closes while the submit thread is mid-decode
        release.set()
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=30)


def test_max_queue_sheds_load(serving_setup, monkeypatch):
    """With the dispatch blocked and max_queue requests queued, submit()
    rejects before any host decode (the poisoned video raises
    ServerOverloadedError, never its OSError); the queued requests complete
    once the dispatch frees up."""
    s, dirs, bad = serving_setup
    release, entered = threading.Event(), threading.Event()
    orig = s._decode_batch_device

    def slow_decode(raw, **kw):
        entered.set()
        assert release.wait(timeout=60)
        return orig(raw, **kw)

    monkeypatch.setattr(s, "_decode_batch_device", slow_decode)
    with DynamicBatcher(s, max_batch_size=1, max_wait_ms=1.0, max_queue=1) as b:
        with ThreadPoolExecutor(max_workers=2) as ex:
            f0 = ex.submit(b.submit, dirs[0])  # → the blocked batch
            # the batcher holds f0's row (its host decode runs off the GIL,
            # so f0 may reach the queue after f1 is submitted unless waited for)
            assert entered.wait(timeout=30)
            deadline = time.time() + 30
            assert b._queue.qsize() == 0
            f1 = ex.submit(b.submit, dirs[1])  # fills the one-slot queue
            while b._queue.qsize() < 1 and time.time() < deadline:
                time.sleep(0.01)
            assert b._queue.qsize() == 1
            with pytest.raises(ServerOverloadedError):
                b.submit(bad)
            release.set()
            monkeypatch.setattr(s, "_decode_batch_device", orig)
            assert f0.result(timeout=60) == s.summarize(dirs[0])
            assert f1.result(timeout=60) == s.summarize(dirs[1])
        assert b.stats["rejected"] == 1
        assert b.stats["requests"] == 2


def test_pipeline_depth_zero_matches_default(serving_setup):
    s, dirs, _ = serving_setup
    expected = {vd: s.summarize(vd) for vd in dirs}
    with DynamicBatcher(s, max_batch_size=2, max_wait_ms=1.0, pipeline_depth=0) as b:
        assert b._completer is None
        for vd in dirs:
            assert b.submit(vd) == expected[vd]
        assert b.stats["requests"] == 3 and b.stats["batches"] == 3
    with pytest.raises(ValueError, match="pipeline_depth"):
        DynamicBatcher(s, max_batch_size=2, pipeline_depth=-1)
    for bad in ({"max_batch_size": 0}, {"max_queue": 0}):
        with pytest.raises(ValueError):
            DynamicBatcher(s, **bad)


def test_pipelined_fetch_error_fails_batch_not_completer(serving_setup, monkeypatch):
    """A device fault surfaces where the picks are fetched: it fails that
    batch's futures on the completion thread, and both threads serve on."""
    s, dirs, _ = serving_setup

    class ExplodingPicks:
        def numpy(self):
            raise RuntimeError("device fault at fetch")

    orig = s._decode_batch_device
    calls = {"n": 0}

    def faulty(raw, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            return None, ExplodingPicks()
        return orig(raw, **kw)

    monkeypatch.setattr(s, "_decode_batch_device", faulty)
    with DynamicBatcher(s, max_batch_size=2, max_wait_ms=1.0) as b:
        with pytest.raises(RuntimeError, match="device fault"):
            b.submit(dirs[0])
        assert b.submit(dirs[1]) == s.summarize(dirs[1])
        assert b._completer.is_alive() and b._thread.is_alive()


# -- bucket ladders ----------------------------------------------------------------


@pytest.fixture(scope="module")
def bucket_setup(tmp_path_factory):
    rng = np.random.default_rng(17)
    cfg = _cfg()
    root = tmp_path_factory.mktemp("bucket_batch_vids")
    short = [_write_video(root / f"vid{v}", rng, cfg,
                          [f"W{(7 * v + 2 * j) % 30} w{(7 * v + 2 * j + 1) % 30}." for j in range(3)],
                          n_frames=2, audio_frac=0.3) for v in range(3)]
    long_vid = _write_video(root / "long", rng, cfg,
                            [f"W{2 * j} w{2 * j + 1} w{(3 * j) % 40}." for j in range(12)],
                            n_frames=2, audio_frac=0.3)
    plain = Summarizer.init_random(cfg, seed=5, vgg_spec=TINY_SPEC, device="cpu")
    bucketed = Summarizer(plain.model, plain.frontend, plain.word2idx, cfg, TINY_SPEC,
                          serve_buckets=True)
    return plain, bucketed, short, long_vid


def test_dynamic_batcher_applies_buckets(bucket_setup):
    plain, bucketed, short, _ = bucket_setup
    want = plain.summarize_batch(short)
    n0 = sum(bucketed.bucket_stats.values())
    with DynamicBatcher(bucketed, max_batch_size=len(short), max_wait_ms=200.0) as b:
        with ThreadPoolExecutor(max_workers=len(short)) as ex:
            got = list(ex.map(b.submit, short))
    assert got == want
    assert sum(bucketed.bucket_stats.values()) > n0


@pytest.mark.parametrize("group", [True, False])
def test_dynamic_batcher_groups_mixed_lengths(bucket_setup, group):
    """A mixed set splits by covering level (the long video at the caps, the
    short ones at a rung level); group_buckets=False keeps one batch. The
    answers equal the plain path's either way."""
    plain, bucketed, short, long_vid = bucket_setup
    vids = short + [long_vid]
    want = plain.summarize_batch(vids)
    bucketed.bucket_stats.clear()
    b = DynamicBatcher(bucketed, max_batch_size=4, max_wait_ms=1.0, group_buckets=group)
    try:
        items = []
        for vd in vids:
            row, sents = bucketed._raw_row(vd)
            items.append((row, sents, Future()))
        b._run_batch(items)  # the grouping path, not thread timing
        got = [it[2].result(timeout=60) for it in items]
    finally:
        b.close()
    assert got == want
    d = plain.cfg.data
    rungs = set(bucketed.bucket_stats)
    if group:
        assert b.stats["bucket_splits"] == 1 and b.stats["batches"] == 2
        assert any(r[0] < d.max_sentences for r in rungs)
    else:
        assert b.stats["bucket_splits"] == 0 and b.stats["batches"] == 1
    assert any(r[0] == d.max_sentences for r in rungs)
