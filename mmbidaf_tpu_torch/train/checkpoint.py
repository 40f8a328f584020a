"""Checkpoints of a ``TrainState`` with ``torch.save``, keeping the best k by a
metric — the port's counterpart of ``mmbidaf_tpu.train.checkpoint`` (orbax
there). The format is the port's own; JAX checkpoints cross through
``interop.from_jax.train_state_from_jax`` instead.

Layout under ``save_dir``: ``step_<N>.pt`` per saved step (written to a
temporary name and renamed, so a reader never sees half a file) and
``index.json`` mapping each step to its metrics, or ``null`` for an unranked
save. As with orbax's ``best_fn`` retention, the ranked saves are pruned to
the best ``max_checkpoints`` by ``metric_name``; unranked saves (the end of a
run between evals, a resume point) are always kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import torch

from mmbidaf_tpu_torch.config import Config, config_from_json
from mmbidaf_tpu_torch.train.loop import TrainState, is_frozen


class CheckpointManager:
    def __init__(self, save_dir: str | os.PathLike, max_checkpoints: int = 5,
                 metric_name: str = "ROUGE-L", maximize: bool = True):
        self.dir = Path(save_dir)
        self.max_checkpoints = max_checkpoints
        self.metric_name = metric_name
        self.maximize = maximize

    def _index(self) -> dict[int, dict | None]:
        path = self.dir / "index.json"
        if not path.exists():
            return {}
        with open(path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def _write_index(self, index: dict[int, dict | None]) -> None:
        tmp = self.dir / "index.json.tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in sorted(index.items())}, f)
        os.replace(tmp, self.dir / "index.json")

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step}.pt"

    def steps(self) -> list[int]:
        return sorted(self._index())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, metrics: dict | None = None) -> None:
        """Save ``state`` at its step, ranked by ``metrics[metric_name]`` when
        ``metrics`` are given, then prune the ranked saves to the best k."""
        self.dir.mkdir(parents=True, exist_ok=True)
        blob = {
            "step": state.step,
            "params": state.params.state_dict(),
            "opt_state": state.opt_state,
            # the EMA shares the frozen table with the params
            "ema_params": {k: v for k, v in state.ema_params.state_dict().items()
                           if not is_frozen(k)},
            "generator": state.generator.get_state(),
        }
        tmp = self._path(state.step).with_suffix(".pt.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, self._path(state.step))
        index = self._index()
        index[state.step] = None if metrics is None else {k: float(v) for k, v in metrics.items()}
        ranked = [s for s, m in index.items() if m is not None and self.metric_name in m]
        ranked.sort(key=lambda s: index[s][self.metric_name], reverse=self.maximize)
        for s in ranked[self.max_checkpoints:]:
            self._path(s).unlink(missing_ok=True)
            del index[s]
        self._write_index(index)

    def save_unranked(self, state: TrainState) -> None:
        """A resume point (a preemption save, the end of a run between
        evals): saved without metrics, so best-k retention never evicts it;
        nothing happens when this step is already on disk (an eval's ranked
        save of it keeps its metrics)."""
        if self.latest_step() != state.step:
            self.save(state)

    def _load_weights(self, step: int, template: TrainState) -> dict:
        """Load step ``step``'s params and EMA shadow into ``template``'s
        modules (in place, on their device); returns the whole blob."""
        dev = template.params.embedding.table.device
        blob = torch.load(self._path(step), map_location=dev, weights_only=True)
        template.params.load_state_dict(blob["params"])
        missing, unexpected = template.ema_params.load_state_dict(blob["ema_params"], strict=False)
        if unexpected or any(not is_frozen(k) for k in missing):
            raise RuntimeError(f"checkpoint step {step}: EMA keys differ "
                               f"(missing {missing}, unexpected {unexpected})")
        return blob

    def restore(self, step: int, template: TrainState) -> TrainState:
        """Load step ``step`` into ``template`` (its modules, in place) and
        return it; tensors go to the template's device."""
        blob = self._load_weights(step, template)
        template.generator.set_state(blob["generator"].cpu())
        return dataclasses.replace(template, step=int(blob["step"]), opt_state=blob["opt_state"])

    def restore_latest(self, template: TrainState) -> TrainState | None:
        """Auto-resume: the newest checkpoint, or None if there is none."""
        step = self.latest_step()
        return None if step is None else self.restore(step, template)

    def warm_start(self, template: TrainState) -> int | None:
        """Load the newest checkpoint's params and EMA shadow into
        ``template`` (its modules, in place), keeping its step, optimizer
        state and dropout generator: another run's weights under a fresh
        schedule. Returns the source step, or None if there is no
        checkpoint. Serving loads a run this way too: the dropout
        generator's state is the saving device's (a CUDA generator's cannot
        enter a CPU one), and serving needs only the weights."""
        step = self.latest_step()
        return None if step is None else int(self._load_weights(step, template)["step"])


def save_config(save_dir: str | os.PathLike, cfg: Config) -> None:
    """The full config next to the checkpoints."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def load_config(save_dir: str | os.PathLike) -> Config:
    return config_from_json(os.path.join(save_dir, "config.json"))
