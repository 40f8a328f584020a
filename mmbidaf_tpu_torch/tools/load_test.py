"""Serving load test: concurrent clients posting mixed-length videos to the
port's daemon — the counterpart of the repository's ``tools/load_test.py``.

N client threads post ``/summarize`` requests for videos of three length
tiers (a quarter, a half and all of the config's caps) to the real
``tools/serve.py`` HTTP stack, in this process on a free port, and report
p50/p95/p99 request latency and sustained videos/s for each serving
configuration:

  * ``seq``             — the plain daemon (its handler lock serializes the card)
  * ``batch``           — ``DynamicBatcher`` coalescing, the pipelined fetch
  * ``batch_sync``      — the same with ``pipeline_depth=0`` (the fetch blocks
                          the next batch's collate and dispatch)
  * ``bucket_group``    — bucket-ladder trims, requests grouped by covering level
  * ``bucket_nogroup``  — bucket-ladder trims, one batch for a mixed set

Every configuration serves the same weights (random from a seed, or a run's
with ``--run_dir``). Each first posts one request a tier outside the
measured window, so first-shape costs stay out of it.

    python -m mmbidaf_tpu_torch.tools.load_test --out load.json        # on the card
    python -m mmbidaf_tpu_torch.tools.load_test --tiny --device cpu --requests 12 --clients 4
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import math
import os
import queue as queue_mod
import sys
import tempfile
import threading
import time
import wave as wave_mod

import numpy as np

TIERS = {"quarter": 0.25, "half": 0.5, "full": 1.0}
CONFIGS = ("seq", "batch", "batch_sync", "bucket_group", "bucket_nogroup")


# -- synthetic mixed-length corpus -------------------------------------------

def write_video_dir(vd: str, rng: np.random.Generator, *, n_frames: int, n_samples: int,
                    n_sents: int, res: tuple[int, int], sample_rate: int) -> None:
    """One video in the serving layout (frames/, audio.wav, transcript.txt)."""
    from PIL import Image

    h, w = res
    os.makedirs(os.path.join(vd, "frames"), exist_ok=True)
    for i in range(n_frames):
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(vd, "frames", f"f{i:04d}.png"))
    sig = (np.sin(np.arange(n_samples) * rng.uniform(0.02, 0.2)) * 18000).astype(np.int16)
    with wave_mod.open(os.path.join(vd, "audio.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(sig.tobytes())
    sents = [f"Clip sentence {j} covers item {int(rng.integers(999))}." for j in range(n_sents)]
    with open(os.path.join(vd, "transcript.txt"), "w") as f:
        f.write(" ".join(sents))


def make_mixed_corpus(root: str, cfg, *, per_tier: int = 2, res: tuple[int, int] = (48, 64),
                      seed: int = 0) -> dict[str, list[str]]:
    """``per_tier`` videos at each tier's fraction of the caps, by tier."""
    rng = np.random.default_rng(seed)
    d = cfg.data
    cap_samples = d.max_audio_frames * d.hop_length + d.win_length
    dirs: dict[str, list[str]] = {}
    for tier, frac in TIERS.items():
        dirs[tier] = []
        for v in range(per_tier):
            vd = os.path.join(root, f"{tier}_{v}")
            write_video_dir(vd, rng, n_frames=max(1, round(frac * d.max_keyframes)),
                            n_samples=max(d.win_length + 1, round(frac * cap_samples)),
                            n_sents=max(2, round(frac * d.max_sentences)),
                            res=res, sample_rate=d.sample_rate)
            dirs[tier].append(vd)
    return dirs


# -- the clients --------------------------------------------------------------

def percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile, index ceil(q·n) - 1 (as the daemon's /healthz)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))]


def post(port: int, video_dir: str, timeout: float) -> tuple[int, str]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/summarize", json.dumps({"video_dir": video_dir}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def drive(port: int, dirs_by_tier: dict[str, list[str]], *, clients: int, requests: int,
          timeout: float, seed: int = 0) -> dict:
    """``requests`` requests drawn from every tier, from ``clients`` threads:
    the stats row, with each video's distinct answers under ``answers``."""
    rng = np.random.default_rng(seed)
    pool = [(t, d) for t, ds in dirs_by_tier.items() for d in ds]
    work: queue_mod.Queue = queue_mod.Queue()
    for _ in range(requests):
        work.put(pool[int(rng.integers(len(pool)))])
    records: list[tuple[str, float, int]] = []
    answers: dict[str, set] = {}
    lock = threading.Lock()
    barrier = threading.Barrier(clients + 1)

    def client():
        barrier.wait()
        while True:
            try:
                tier, vd = work.get_nowait()
            except queue_mod.Empty:
                return
            t0 = time.monotonic()
            try:
                code, body = post(port, vd, timeout)
            except OSError:
                code, body = -1, ""
            dt = time.monotonic() - t0
            with lock:
                records.append((tier, dt, code))
                if code == 200:
                    answers.setdefault(vd, set()).add(json.loads(body)["summary"])

    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t_start = time.monotonic()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    lats = [dt for _, dt, code in records if code == 200]
    by_tier = {tier: [dt for tr, dt, code in records if tr == tier and code == 200]
               for tier in dirs_by_tier}
    return {
        "requests": len(records),
        "ok": len(lats),
        "errors": len(records) - len(lats),
        "wall_s": wall,
        "sustained_vps": len(lats) / wall if wall > 0 else 0.0,
        "latency_ms": {"p50": percentile(lats, 50) * 1e3, "p95": percentile(lats, 95) * 1e3,
                       "p99": percentile(lats, 99) * 1e3,
                       "mean": float(np.mean(lats)) * 1e3 if lats else None},
        "per_tier_p50_ms": {t: percentile(v, 50) * 1e3 for t, v in by_tier.items()},
        "per_tier_p95_ms": {t: percentile(v, 95) * 1e3 for t, v in by_tier.items()},
        "answers": {vd: sorted(s) for vd, s in answers.items()},
    }


# -- one configuration --------------------------------------------------------

def run_config(summarizer, dirs_by_tier: dict[str, list[str]], *, name: str, clients: int,
               requests: int, dynamic_batch: int = 0, group_buckets: bool = True,
               batch_wait_ms: float = 5.0, pipeline_depth: int = 1,
               http_timeout: float = 600.0, seed: int = 0) -> dict:
    """Serve ``summarizer`` over HTTP and load it; returns the stats row."""
    from mmbidaf_tpu_torch.serving import DynamicBatcher
    from mmbidaf_tpu_torch.tools.serve import serve

    batcher = None
    if dynamic_batch:
        batcher = DynamicBatcher(summarizer, max_batch_size=dynamic_batch, max_wait_ms=batch_wait_ms,
                                 group_buckets=group_buckets, pipeline_depth=pipeline_depth)
    srv = serve(summarizer, port=0, batcher=batcher)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        # one request a tier outside the measured window
        for tier, vds in dirs_by_tier.items():
            code, body = post(port, vds[0], http_timeout)
            if code != 200:
                raise RuntimeError(f"[{name}] first request of tier {tier} failed: {body}")
        stats = drive(port, dirs_by_tier, clients=clients, requests=requests,
                      timeout=http_timeout, seed=seed)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
        if batcher is not None:
            batcher.close()
    stats["config"] = name
    if batcher is not None:
        stats["batcher"] = dict(batcher.stats)
    return stats


def run_sweep(make_summarizer, dirs_by_tier, *, configs=CONFIGS, clients=8, requests=48,
              dynamic_batch=8, batch_wait_ms=5.0, http_timeout=600.0) -> list[dict]:
    """Run ``configs``; ``make_summarizer(buckets: bool)`` gives (and may
    cache) a summarizer with or without bucket-ladder serving."""
    rows = []
    for name in configs:
        s = make_summarizer(name.startswith("bucket"))
        kw = dict(clients=clients, requests=requests, batch_wait_ms=batch_wait_ms,
                  http_timeout=http_timeout)
        if name != "seq":
            kw.update(dynamic_batch=dynamic_batch, group_buckets=name != "bucket_nogroup",
                      pipeline_depth=0 if name == "batch_sync" else 1)
        r = run_config(s, dirs_by_tier, name=name, **kw)
        rows.append(r)
        lm = r["latency_ms"]
        print(f"{name:16s} ok={r['ok']}/{r['requests']} p50={lm['p50']:.3f}ms "
              f"p95={lm['p95']:.3f}ms p99={lm['p99']:.3f}ms "
              f"sustained={r['sustained_vps']:.3f} videos/s", flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run_dir", default=None,
                    help="serve this train.cli run (default: the bench config, random weights)")
    ap.add_argument("--tiny", action="store_true", help="tiny test config and TINY_SPEC (CPU)")
    ap.add_argument("--corpus", default=None,
                    help="existing corpus root (one tier 'all'); default: synthesize tiers")
    ap.add_argument("--per_tier", type=int, default=2)
    ap.add_argument("--res", default="48x64", metavar="HxW", help="frame size of synthesized videos")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--dynamic_batch", type=int, default=8)
    ap.add_argument("--batch_wait_ms", type=float, default=5.0)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--http_timeout", type=float, default=600.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)

    import torch

    from mmbidaf_tpu_torch import resolve_device
    from mmbidaf_tpu_torch.config import Config, tiny_test_config
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC, VGG16_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer

    dev = resolve_device(a.device)
    if a.tiny:
        cfg, spec = tiny_test_config(), TINY_SPEC
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc))
    else:
        cfg, spec = Config(), VGG16_SPEC
    cache: dict[bool, Summarizer] = {}

    def make_summarizer(buckets: bool) -> Summarizer:
        if buckets not in cache:
            sb = True if buckets else None
            if a.run_dir:
                cache[buckets] = Summarizer.from_run(a.run_dir, serve_buckets=sb, device=dev)
            elif cache:  # the other summarizer's weights
                o = next(iter(cache.values()))
                cache[buckets] = Summarizer(o.model, o.frontend, o.word2idx, o.cfg, o.vgg_spec,
                                            serve_buckets=sb)
            else:
                cache[buckets] = Summarizer.init_random(cfg, seed=0, vgg_spec=spec, device=dev,
                                                        serve_buckets=sb)
        return cache[buckets]

    with tempfile.TemporaryDirectory(prefix="mmb_load_") as root:
        if a.corpus:
            dirs_by_tier = {"all": sorted(os.path.join(a.corpus, d) for d in os.listdir(a.corpus)
                                          if os.path.isdir(os.path.join(a.corpus, d)))}
        else:
            h, w = (int(x) for x in a.res.split("x"))
            dirs_by_tier = make_mixed_corpus(root, make_summarizer(False).cfg,
                                             per_tier=a.per_tier, res=(h, w), seed=a.seed)
        rows = run_sweep(make_summarizer, dirs_by_tier, configs=tuple(a.configs.split(",")),
                         clients=a.clients, requests=a.requests, dynamic_batch=a.dynamic_batch,
                         batch_wait_ms=a.batch_wait_ms, http_timeout=a.http_timeout)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    report = {"device": device, "clients": a.clients, "requests": a.requests,
              "dynamic_batch": a.dynamic_batch, "res": a.res, "per_tier": a.per_tier,
              "configs": rows}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {a.out}")
    print(json.dumps({r["config"]: r["latency_ms"] for r in rows}))


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("load_test interrupted", file=sys.stderr)
        raise SystemExit(130)
