"""Parallelism demo: DP × SP × TP end to end — the port of
``examples/parallel_demo.py``.

    python -m mmbidaf_tpu_torch.examples.parallel_demo --device cpu   # 8 gloo processes
    python -m mmbidaf_tpu_torch.examples.parallel_demo                 # one card, world size 1

1. writes a small synthetic video corpus (``examples/make_synthetic_corpus.py``)
   and the tiny config (``examples/tiny_config.json``) with the hand kernels on;
2. trains a few steps with all three layouts on one
   ``data`` × ``seq`` × ``model`` mesh (``train.cli --num_data --num_seq
   --sp_audio --num_model --tp_vgg``): the batch split over ``data``, the
   audio frames over ``seq`` (SP MFCC → SP BiLSTM → ring BiDAF), the VGG
   classifier over ``model`` (fc1 column-, fc2 row-parallel);
3. evaluates the run under the same mesh (``infer``);
4. serves the run DP × TP (the layout is a deploy-time choice:
   ``Summarizer.from_run(mesh_overrides=…)``), exports it as a mesh
   artifact (format 2: the per-rank programs), loads it in the same group
   and checks that its summaries equal the live ones.

With ``--device cpu`` the demo starts one process a mesh position
(2 data × 2 seq × 2 model), each joining a gloo group on a ``file://``
store, where the JAX demo fakes 8 CPU devices. On the card it runs the
same stages at world size 1, every layout flag on, through NCCL, in this
process. Every stage is
the code path the CLIs run. The demo ends with ``parallel demo OK``;
``main`` returns rank 0's result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FRAME_HW = (48, 64)  # the corpus' frames
SERVE_BATCH = 8
GROUP_TIMEOUT_S = 600.0
MODULE = "mmbidaf_tpu_torch.examples.parallel_demo"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "mmbidaf_torch_parallel_demo"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    # each axis: 2 processes on the CPU (8 in all); one card runs world size 1
    a.num_data = a.num_seq = a.num_model = 2 if a.device == "cpu" else 1
    return a


def paths(a) -> dict[str, str]:
    w = a.workdir
    return {"corpus": os.path.join(w, "corpus"), "runs": os.path.join(w, "runs"),
            "artifact": os.path.join(w, "artifact"), "result": os.path.join(w, "result.json"),
            "config": os.path.join(w, "config.json")}


def write_config(path: str) -> None:
    """``examples/tiny_config.json`` with the hand kernels on (K1-K3 serving,
    K5-K8 training): each kernel wrapper is one node of an exported program,
    where a plain step loop is one node a step."""
    with open(os.path.join(REPO, "examples", "tiny_config.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(use_pallas_attention=True, use_pallas_lstm=True, use_pallas_melspec=True)
    with open(path, "w") as f:
        json.dump(cfg, f)


def run_stages(a) -> dict:
    """Stages 2-4 on this process's rank of the default group (every rank
    runs them; rank 0 alone prints and writes)."""
    import torch.distributed as dist

    from mmbidaf_tpu_torch import infer
    from mmbidaf_tpu_torch.export import ExportedSummarizer, export_summarizer
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.train import cli

    p = paths(a)
    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *x, **kw: None)
    t0 = time.perf_counter()
    # 2. train on the three-axis mesh
    cli.main(["--data_dir", p["corpus"], "--vgg", "tiny",
              "--config_json", p["config"],
              "--num_data", str(a.num_data), "--sp_audio", "--num_seq", str(a.num_seq),
              "--tp_vgg", "--num_model", str(a.num_model), "--num_steps", str(a.steps),
              "--batch_size", str(4 * a.num_data), "--save_dir", p["runs"], "--device", a.device])
    t_train = time.perf_counter() - t0
    # 3. evaluate through the same mesh (the run's saved config carries it)
    run_dir = os.path.join(p["runs"], "mmbidaf")
    infer.main(["--data_dir", p["corpus"], "--load_dir", os.path.join(run_dir, "ckpts"),
                "--device", a.device])
    t_infer = time.perf_counter() - t0 - t_train
    # 4. the same run served DP x TP (no SP: the serving host picks its own
    #    mesh), frozen as a mesh artifact, reloaded by the same group
    world = dist.get_world_size()
    s = Summarizer.from_run(
        run_dir, mesh_overrides={"sp_audio": False, "num_seq": 1, "num_data": world // a.num_model,
                                 "num_model": a.num_model, "tp_vgg": True},
        data_parallel=True, serve_batch_size=SERVE_BATCH, device=a.device)
    videos = sorted(os.path.join(p["corpus"], v) for v in os.listdir(p["corpus"]))
    live = s.summarize_batch(videos)
    say(f"DP x TP serving {s.parallelism()}: {live[0]!r}", flush=True)
    export_summarizer(s, p["artifact"], batch_size=SERVE_BATCH, frame_hw=FRAME_HW)
    art = ExportedSummarizer(p["artifact"], device=s.device)
    frozen = art.summarize_batch(videos)
    if frozen != live:
        raise SystemExit(f"rank {rank}: the artifact's summaries diverge from live serving")
    say(f"mesh artifact reproduces live serving on {len(videos)} videos", flush=True)
    return {"world": world, "mesh": {"data": a.num_data, "seq": a.num_seq, "model": a.num_model},
            "serving": s.parallelism(), "videos": len(videos), "summaries": live,
            "artifact_equal": frozen == live, "train_s": t_train, "infer_s": t_infer,
            "serve_export_s": time.perf_counter() - t0 - t_train - t_infer}


def worker(a) -> dict:
    """One rank: join the group the environment names, run the stages, leave."""
    import torch.distributed as dist

    from mmbidaf_tpu_torch.parallel.mesh import initialize_distributed

    if not initialize_distributed(a.device):
        raise SystemExit("parallel_demo --worker: the environment names no process group")
    try:
        res = run_stages(a)
        if dist.get_rank() == 0:
            with open(paths(a)["result"], "w") as f:
                json.dump(res, f)
        dist.barrier()
        return res
    finally:
        dist.destroy_process_group()


def group_env(a, world: int, rank: int) -> dict:
    return {"COORDINATOR_ADDRESS": f"file://{os.path.join(a.workdir, 'store')}",
            "NUM_PROCESSES": str(world), "PROCESS_ID": str(rank)}


def launch(a, argv: list[str], world: int) -> None:
    """``world`` worker processes of this module (one a mesh position), each
    its log in the work directory; every one is stopped when one fails or
    the group outlives GROUP_TIMEOUT_S."""
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", **group_env(a, world, r),
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        log = open(os.path.join(a.workdir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-u", "-m", MODULE, "--worker",
                                       *argv], stdout=log, stderr=subprocess.STDOUT, env=env,
                                      cwd=REPO))
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    print(texts[0], end="", flush=True)
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise SystemExit(f"parallel demo: ranks failed (rank, rc) {bad}:\n"
                         + "\n".join(f"--- rank {r}\n{texts[r][-3000:]}" for r, _ in bad))


def main(argv=None) -> dict:
    from mmbidaf_tpu_torch import resolve_device
    from mmbidaf_tpu_torch.examples import make_synthetic_corpus

    argv = list(sys.argv[1:] if argv is None else argv)
    a = parse_args(argv)
    resolve_device(a.device)
    if a.worker:
        return worker(a)
    shutil.rmtree(a.workdir, ignore_errors=True)
    os.makedirs(a.workdir)
    # 1. the synthetic corpus
    make_synthetic_corpus.make_corpus(paths(a)["corpus"], videos=6, sentences=8, frames=4,
                                      seconds=1.5)
    write_config(paths(a)["config"])
    world = a.num_data * a.num_seq * a.num_model
    print(f"corpus of 6 videos; mesh data {a.num_data} x seq {a.num_seq} x model "
          f"{a.num_model} over {world} process(es) on {a.device}", flush=True)
    if world == 1:
        saved = {k: os.environ.get(k) for k in group_env(a, 1, 0)}
        os.environ.update(group_env(a, 1, 0))
        try:
            res = worker(a)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    else:
        launch(a, argv, world)
        with open(paths(a)["result"]) as f:
            res = json.load(f)
    if not res["artifact_equal"]:
        raise SystemExit("parallel demo: the artifact's summaries diverge from live serving")
    print("parallel demo OK", flush=True)
    return res


if __name__ == "__main__":
    main()
