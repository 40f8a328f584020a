"""HTTP serving daemon around the port's ``Summarizer`` (standard library
HTTP only) — the counterpart of the repository's ``tools/serve.py``.

    python -m mmbidaf_tpu_torch.tools.serve --run_dir runs/NAME [--port 8080] \\
        [--mode greedy|topk|beam] [--serve_batch_size 8] [--long] \\
        [--bucket_serving [--bucket_ladders ladders.json]] \\
        [--dynamic_batch 8 --batch_wait_ms 5 --max_queue 64 --pipeline_depth 1] \\
        [--warmup 240x320] [--device cuda]
    python -m mmbidaf_tpu_torch.tools.serve --artifact artifact/ [--dynamic_batch B] \\
        [--warmup HxW] [--long] [--device cuda]

Endpoints:
    GET  /healthz          → {"ok": true, "backend": ..., "decode_mode": ...,
                              "latency": {endpoint: count, errors, p50_ms, p95_ms},
                              "batcher": {...}, "buckets": {"TsxWxTixTa": n},
                              "artifact": {"format_version": ..., ...}}
    POST /summarize        {"video_dir": "/path"}        → {"summary": ...}
    POST /summarize_batch  {"video_dirs": ["/a", "/b"]}  → {"summaries": [...]}

Requests are served from a thread pool. Without ``--dynamic_batch`` a
handler lock lets one request at a time onto the card; with it,
``/summarize`` goes through ``serving.DynamicBatcher``, which coalesces
concurrent requests into device batches (``--max_queue`` sheds load with a
503). A bad asset gets a 400 and the server keeps serving; any other
failure, a device fault included, is a 500: no request that failed on the
card is answered with a summary. SIGTERM drains like Ctrl-C. ``--warmup``
runs every serving shape once (``Summarizer.warmup``) before the daemon
listens.

``--artifact DIR`` serves a frozen artifact (``tools/export_artifact.py``)
through ``export.ExportedSummarizer``: its decode mode, batch and bucket
levels were fixed at export, so ``--mode``, ``--serve_batch_size``,
``--bucket_serving`` and ``--bucket_ladders`` are conflicts,
``--dynamic_batch`` must equal the artifact's batch, and ``--warmup`` runs
the artifact's programs at its frame size. ``/healthz`` then shows the
artifact's format.

Not ported: ``--data_parallel``, ``--tp_vgg`` and ``--num_model`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time
from collections import defaultdict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class LatencyStats:
    """Bounded per-endpoint latency window → count, errors, p50, p95."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._lat = defaultdict(lambda: deque(maxlen=window))
        self._count = defaultdict(int)
        self._errors = defaultdict(int)

    def record(self, endpoint: str, seconds: float, ok: bool) -> None:
        with self._lock:
            self._lat[endpoint].append(seconds)
            self._count[endpoint] += 1
            if not ok:
                self._errors[endpoint] += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for ep, window in self._lat.items():
                lat = sorted(window)
                n = len(lat)
                # nearest rank, ceil(q·n) - 1: p95 >= p50 at any n
                q = lambda p: lat[max(0, math.ceil(p * n) - 1)]  # noqa: E731
                out[ep] = {"count": self._count[ep], "errors": self._errors[ep],
                           "p50_ms": round(q(0.50) * 1e3, 2), "p95_ms": round(q(0.95) * 1e3, 2)}
            return out


def make_handler(summarizer, use_long: bool, batcher=None):
    import wave as wave_mod

    from mmbidaf_tpu_torch.serving import ServerOverloadedError

    backend = summarizer.device.type
    latency = LatencyStats()
    dec = getattr(summarizer, "decoder", None)  # a frozen artifact
    artifact = None if dec is None else {
        k: dec.manifest[k] for k in ("format_version", "device", "torch_version", "batch_size",
                                     "frame_hw", "compute_dtype", "decode_mode", "beam_width")}
    if artifact is not None:
        artifact["bucket_programs"] = len(dec.bucket_levels)
    bucketed = dec.bucket_levels if dec is not None else summarizer._ladders is not None

    class Handler(BaseHTTPRequestHandler):
        # one request at a time on the card keeps its memory bounded; the
        # next request's host decode still overlaps through the thread pool.
        # /summarize with a batcher bypasses it: the batcher coalesces.
        _lock = threading.Lock()

        def _reply(self, code: int, payload: dict, retry_after: float | None = None) -> int:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(retry_after))
            self.end_headers()
            self.wfile.write(body)
            return code

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            payload = {"ok": True, "backend": backend, "decode_mode": summarizer.mode,
                       "latency": latency.snapshot()}
            if batcher is not None:
                payload["batcher"] = dict(batcher.stats)
            if artifact is not None:
                payload["artifact"] = artifact
            if bucketed:
                with summarizer._stats_lock:
                    payload["buckets"] = {"x".join(map(str, k)): v
                                          for k, v in summarizer.bucket_stats.items()}
            self._reply(200, payload)

        def do_POST(self):
            t0 = time.monotonic()
            code = self._post()
            if self.path in ("/summarize", "/summarize_batch"):
                latency.record(self.path, time.monotonic() - t0, ok=code == 200)

        def _post(self) -> int:
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except Exception as e:
                return self._reply(400, {"error": f"bad request body: {e}"})
            # the request's fields are checked outside the handler's try: a
            # KeyError inside the summarizer is not a missing field
            field = {"/summarize": "video_dir", "/summarize_batch": "video_dirs"}.get(self.path)
            if field is None:
                return self._reply(404, {"error": f"unknown path {self.path}"})
            if field not in req:
                return self._reply(400, {"error": f"missing field {field!r}"})
            try:
                if self.path == "/summarize":
                    if batcher is not None and not use_long:
                        out = batcher.submit(req["video_dir"])  # no lock: coalesced
                    else:
                        with self._lock:
                            out = (summarizer.summarize_long(req["video_dir"]) if use_long
                                   else summarizer.summarize(req["video_dir"]))
                    return self._reply(200, {"summary": out})
                with self._lock:
                    outs = summarizer.summarize_batch(list(req["video_dirs"]))
                return self._reply(200, {"summaries": outs})
            except ServerOverloadedError as e:
                return self._reply(503, {"error": str(e), "kind": "overloaded"}, retry_after=1)
            except (OSError, ValueError, wave_mod.Error, EOFError) as e:
                # an unreadable or malformed asset fails the request, not the server
                return self._reply(400, {"error": f"{type(e).__name__}: {e}", "kind": "bad_asset"})
            except Exception as e:
                # a server fault (a device error among them): 500, never a summary
                return self._reply(500, {"error": f"{type(e).__name__}: {e}", "kind": "server_error"})

    return Handler


class Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 drops the connections of a burst
    # past it, and their clients retry a second later
    request_queue_size = 128
    # non-daemon handler threads are the ones server_close() joins: a drain
    # finishes the running request instead of killing its thread at exit
    daemon_threads = False


def serve(summarizer, port: int = 8080, host: str = "127.0.0.1", use_long: bool = False,
          batcher=None) -> Server:
    """Build (but do not run) the server; the caller owns serve_forever()."""
    return Server((host, port), make_handler(summarizer, use_long, batcher=batcher))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--run_dir", help="a train.cli run directory (config, vocab, ckpts)")
    src.add_argument("--artifact", help="a frozen artifact directory (export.py)")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--mode", default="greedy", choices=["greedy", "topk", "beam"])
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument("--bucket_serving", action="store_true",
                    help="trim each device batch to the quarter/half/full rungs covering its "
                         "true lengths (outputs unchanged)")
    ap.add_argument("--bucket_ladders", default=None, metavar="FILE.json",
                    help="explicit per-axis ladders for --bucket_serving (suggest_buckets JSON)")
    ap.add_argument("--serve_batch_size", type=int, default=None,
                    help="pad and chunk requests to one batch shape")
    ap.add_argument("--long", action="store_true",
                    help="windowed decode for transcripts past max_sentences")
    ap.add_argument("--dynamic_batch", type=int, default=0, metavar="N",
                    help="coalesce concurrent /summarize requests into device batches of N "
                         "(0 = off; not with --long)")
    ap.add_argument("--batch_wait_ms", type=float, default=5.0,
                    help="longest wait of the batcher to fill a batch")
    ap.add_argument("--max_queue", type=int, default=0, metavar="N",
                    help="with --dynamic_batch: 503 once N requests are pending (0 = unbounded)")
    ap.add_argument("--pipeline_depth", type=int, default=1, metavar="N",
                    help="with --dynamic_batch: dispatched batches waiting to be fetched while "
                         "the next is collated (0 = synchronous)")
    ap.add_argument("--warmup", default="", metavar="HxW",
                    help="run the serving shapes at startup on zero frames of HxW (the "
                         "corpus's frame size, e.g. 240x320)")
    ap.add_argument("--data_parallel", action="store_true", help="not ported: raises")
    ap.add_argument("--tp_vgg", type=int, choices=[0, 1], default=None, help="not ported: raises")
    ap.add_argument("--num_model", type=int, default=None, help="not ported: raises")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap, ap.parse_args(argv)


def main(argv=None) -> None:
    ap, a = parse_args(argv)
    if a.data_parallel or a.tp_vgg is not None or a.num_model is not None:
        raise NotImplementedError("--data_parallel, --tp_vgg and --num_model: the mesh layouts "
                                  "are not ported yet (ROADMAP Queue 1)")
    if a.artifact:
        # the artifact is the program: its mode, batch and levels were fixed
        # at export (--dynamic_batch must equal its batch; --long windows
        # through the frozen program)
        for flag, name in ((a.mode != "greedy", "--mode"),
                           (a.serve_batch_size, "--serve_batch_size"),
                           (a.bucket_serving, "--bucket_serving"),
                           (a.bucket_ladders, "--bucket_ladders")):
            if flag:
                ap.error(f"{name} is fixed at export time — re-export the artifact (or serve "
                         "interactively via --run_dir)")
    if a.dynamic_batch and a.long:
        ap.error("--dynamic_batch batches whole-video requests; --long's windowed decode "
                 "batches internally — pick one")
    serve_buckets = a.bucket_serving or None
    if a.bucket_ladders:
        if not a.bucket_serving:
            ap.error("--bucket_ladders configures --bucket_serving — pass both")
        try:
            with open(a.bucket_ladders) as f:
                serve_buckets = json.load(f)
        except (OSError, ValueError) as e:
            ap.error(f"--bucket_ladders {a.bucket_ladders}: {e}")
        if not isinstance(serve_buckets, dict) or not serve_buckets:
            ap.error(f"--bucket_ladders {a.bucket_ladders}: expected a non-empty JSON dict of "
                     "per-axis rung lists")
    if serve_buckets is not None:
        # the ladders checked against the run's config before the load
        from mmbidaf_tpu_torch.serving import serving_bucket_ladders
        from mmbidaf_tpu_torch.train.checkpoint import load_config

        try:
            run_cfg = load_config(a.run_dir)
        except (OSError, ValueError):
            run_cfg = None  # from_run reports a broken run directory itself
        if run_cfg is not None:
            try:
                serving_bucket_ladders(run_cfg, serve_buckets)
            except ValueError as e:
                ap.error(f"--bucket_serving/--bucket_ladders: {e}")
    warmup_hw = None
    if a.warmup:
        try:
            warmup_hw = tuple(int(x) for x in a.warmup.lower().split("x"))
            if len(warmup_hw) != 2:
                raise ValueError(a.warmup)
        except ValueError:
            ap.error(f"--warmup wants HxW (e.g. 240x320), got {a.warmup!r}")

    # SIGTERM drains like Ctrl-C; installed before the load and the warmup,
    # so a stop during either unwinds too. A second SIGTERM terminates.
    import signal

    def _sigterm(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        raise KeyboardInterrupt

    previous = signal.signal(signal.SIGTERM, _sigterm)
    try:
        run(a, serve_buckets, warmup_hw, ap)
    finally:  # a caller that runs main in-process keeps its own handler
        signal.signal(signal.SIGTERM, previous)


def run(a, serve_buckets, warmup_hw, ap) -> None:
    from mmbidaf_tpu_torch.serving import DynamicBatcher, Summarizer

    batcher = None
    try:
        if a.artifact:
            from mmbidaf_tpu_torch.export import ExportedSummarizer

            s = ExportedSummarizer(a.artifact, device=a.device)
            if warmup_hw is not None and warmup_hw != s.decoder.frame_hw:
                ap.error(f"--warmup {a.warmup} != the artifact's frame_hw {s.decoder.frame_hw}")
            if a.dynamic_batch and a.dynamic_batch != s.fixed_batch_size:
                ap.error(f"--dynamic_batch {a.dynamic_batch} != the artifact's batch "
                         f"{s.fixed_batch_size}, fixed at export time")
        else:
            s = Summarizer.from_run(a.run_dir, mode=a.mode, topk=a.topk,
                                    serve_batch_size=a.serve_batch_size,
                                    serve_buckets=serve_buckets, device=a.device)
        # the batcher before the warmup: its checks fail fast
        if a.dynamic_batch:
            batcher = DynamicBatcher(s, max_batch_size=a.dynamic_batch, max_wait_ms=a.batch_wait_ms,
                                     max_queue=a.max_queue or None, pipeline_depth=a.pipeline_depth)
        if warmup_hw is not None:
            t0 = time.monotonic()
            if a.artifact:
                s.warmup()
            else:
                s.warmup(warmup_hw, batch_size=a.dynamic_batch or None, include_long=a.long)
            print(f"warmup: serving shapes run in {time.monotonic() - t0:.1f} s", flush=True)
    except KeyboardInterrupt:
        if batcher is not None:
            batcher.close()
        print("stopped during startup")
        return
    srv = serve(s, port=a.port, host=a.host, use_long=a.long, batcher=batcher)
    print(f"serving {a.run_dir or a.artifact} on http://{a.host}:{srv.server_address[1]} "
          f"(mode={s.mode}, device={s.device}{', long' if a.long else ''}"
          f"{f', dynamic_batch={a.dynamic_batch}' if batcher else ''})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
        srv.server_close()  # joins the handler threads in flight: the drain
    finally:
        if batcher is not None:
            batcher.close()


if __name__ == "__main__":
    main()
