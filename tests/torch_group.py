"""Gloo process groups on the CPU for the port's multi-process tests.

A test file that holds cases (functions of one ``inputs`` dict, run by every
rank of a group) is also the workers' script: ``python FILE worker RANK
WORLD STORE PLAN OUT_DIR`` runs ``worker_main(CASES, argv)``, which joins a
gloo group on a ``FileStore`` and runs every case of the pickled plan in
order, each rank writing its results as ``.npz``. The workers import torch
and the port only, never ``jax``. ``spawn`` starts the group, bounds its
run with a time limit (every process is killed when one hangs) and puts
each rank's log in the assertion message when a rank fails.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 240.0


def worker_main(cases: dict, argv: list[str]) -> None:
    """The worker side: ``argv`` = ``[RANK, WORLD, STORE, PLAN, OUT_DIR]``."""
    import torch
    import torch.distributed as dist

    rank, world, store, plan_path, out_dir = int(argv[0]), int(argv[1]), *argv[2:5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    for i, (name, inputs) in enumerate(plan):
        res = cases[name](inputs)
        dist.barrier()
        np.savez(os.path.join(out_dir, f"{i}.{name}.r{rank}.npz"),
                 **{k: v for k, v in res.items() if v is not None})
    dist.barrier()
    dist.destroy_process_group()


def start(argvs: list[list[str]], tmp_dir: str, envs: list[dict] | None = None
          ) -> tuple[list, list]:
    """Start one process per argv, each with its ``envs`` entry added to the
    environment (logs in ``tmp_dir/r{i}.log``)."""
    procs, logs = [], []
    for r, argv in enumerate(argvs):
        extra = envs[r] if envs else {}
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, **extra)
        log = open(os.path.join(tmp_dir, f"r{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-u", *argv], stdout=log,
                                      stderr=subprocess.STDOUT, env=env, cwd=REPO))
    return procs, logs


def finish(procs: list, logs: list, deadline: float, what: str) -> list[str]:
    """Wait for every process until ``deadline`` (``time.monotonic``), kill
    the ones left; return the logs, or raise with them when a rank failed."""
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
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
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{what} failed (rank, rc) {bad}:\n"
                             + "\n".join(t[-3000:] for t in texts))
    return texts


def spawn(script: str, tmp_dir: str, world: int, plan: list,
          timeout: float = GROUP_TIMEOUT) -> list[list]:
    """Run ``plan`` (``[(case, inputs)]``) in a gloo group of ``world``
    processes of ``script``; return, for each case, every rank's results
    (rank order)."""
    os.makedirs(tmp_dir, exist_ok=True)
    plan_path = os.path.join(tmp_dir, "plan.pkl")
    with open(plan_path, "wb") as f:
        pickle.dump(plan, f)
    store = os.path.join(tmp_dir, "store")
    procs, logs = start([[os.path.abspath(script), "worker", str(r), str(world), store,
                          plan_path, tmp_dir] for r in range(world)], tmp_dir)
    finish(procs, logs, time.monotonic() + timeout, f"gloo group of {world}")
    return [[dict(np.load(os.path.join(tmp_dir, f"{i}.{name}.r{r}.npz"))) for r in range(world)]
            for i, (name, _) in enumerate(plan)]
