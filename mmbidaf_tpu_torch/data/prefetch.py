"""Device prefetch for the training loop — the port of
``mmbidaf_tpu.data.prefetch``.

A background thread pulls host batches from the wrapped iterator, uploads
them (``to_device``) and hands ``(host_batch, device_batch)`` pairs to the
consumer through a bounded queue, so the next batch's host collate and its
host-to-device copy overlap the current step.

``batch_uploader(device)`` is the port's upload. On the card the thread pins
each host array and copies it with ``non_blocking=True`` on a side
``torch.cuda.Stream``, then records an event there; the copy is in flight
when the thread queues the batch. The consumer's ``__next__`` makes its
current stream wait on that event and marks each tensor as used by that
stream (``record_stream``), so the step's kernels never read a batch before
its copy has landed, and the caching allocator does not hand the memory to
the side stream again while the step still reads it. On the CPU the upload
is ``torch.from_numpy``.

Loader-state exactness (the deterministic-resume contract): ``get_state()``
describes the position after the last DELIVERED batch, not the last
PREFETCHED one — the thread runs up to ``depth`` batches ahead of the
consumer. The thread snapshots the inner iterator's state right after each
``next()`` and attaches it to the item; ``get_state()`` returns the snapshot
carried by the most recently yielded batch (or the pre-thread initial one).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

_SENTINEL = object()


class InFlight:
    """A batch whose copy to the card runs on a side stream."""

    def __init__(self, tensors: dict[str, torch.Tensor], event: torch.cuda.Event,
                 device: torch.device):
        self.tensors = tensors
        self.event = event
        self.device = device

    def claim(self) -> dict[str, torch.Tensor]:
        """Order the caller's current stream after the copy; the tensors are
        then safe to read there."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


def batch_uploader(device: torch.device) -> Callable[[Mapping[str, np.ndarray]], object]:
    """``to_device`` for ``DevicePrefetcher``: numpy batch → tensors on
    ``device`` (an ``InFlight`` on the card, a dict on the CPU)."""
    if device.type != "cuda":
        return lambda nb: {k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()}
    side = torch.cuda.Stream(device)

    def upload(nb: Mapping[str, np.ndarray]) -> InFlight:
        with torch.cuda.stream(side):
            tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                       .to(device, non_blocking=True) for k, v in nb.items()}
            event = torch.cuda.Event()
            event.record(side)
        return InFlight(tensors, event, device)

    return upload


class DevicePrefetcher:
    """Wrap a host batch iterator with a prefetch-and-upload thread.

    Yields ``(host_batch, device_batch)`` where
    ``device_batch = to_device(host_batch)`` (an ``InFlight`` upload is
    claimed on the consumer's current stream before it is yielded).
    Iteration order is exactly the wrapped iterator's. Exceptions raised by
    the inner iterator or the upload surface in the consumer at the position
    they occurred.
    """

    def __init__(self, stream: Iterator, to_device: Callable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._stream = stream
        self._to_device = to_device
        self._has_state = hasattr(stream, "get_state")
        # snapshot BEFORE the thread advances the inner iterator: a
        # get_state() before any batch was consumed must describe the
        # starting position
        self._last_state = stream.get_state() if self._has_state else None
        self._error: BaseException | None = None
        self._closed = False
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, name="mmbidaf-prefetch", daemon=True)
        self._thread.start()

    # -- producer thread ----------------------------------------------------

    def _fill(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    nb = next(self._stream)
                except StopIteration:
                    break
                state = self._stream.get_state() if self._has_state else None
                dev = self._to_device(nb)
                if not self._put((nb, dev, state)):
                    return  # closed while waiting for queue space
        except BaseException as e:  # noqa: BLE001 — surfaced in the consumer
            self._error = e
        self._put(_SENTINEL)

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side ------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            # stay exhausted: re-queue the sentinel so repeated next() raises
            # StopIteration instead of blocking on an empty queue with a
            # dead producer
            self._q.put(_SENTINEL)
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        nb, dev, state = item
        if isinstance(dev, InFlight):
            dev = dev.claim()
        self._last_state = state
        return nb, dev

    def get_state(self):
        """Inner-iterator state as of the last YIELDED batch, or ``None``
        when the wrapped iterator has no ``get_state`` (a caller's hasattr
        probe would otherwise see this method and assume grain)."""
        return self._last_state

    def close(self, timeout: float | None = None) -> bool:
        """Stop the thread and drop prefetched-but-undelivered batches.

        Blocks (by default) until the thread has exited: it may be mid-upload,
        and the wait is bounded by one batch's host work. Returns False if a
        ``timeout`` was given and expired with the thread still alive.
        """
        self._closed = True
        self._stop.set()
        # drain, then leave a sentinel so a consumer parked in self._q.get()
        # unblocks; the producer may sneak one last item in before it notices
        # the stop flag, so drain and retry
        while True:
            try:
                self._q.put_nowait(_SENTINEL)
                break
            except queue.Full:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
