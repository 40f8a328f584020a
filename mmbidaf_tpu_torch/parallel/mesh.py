"""Device mesh and the batch / parameter layouts over ``torch.distributed`` —
the port of ``mmbidaf_tpu.parallel.mesh``.

One process drives one device. The mesh's axes keep the JAX package's names
and order, outer to inner: ``dcn`` (when ``num_dcn > 1``) × ``data`` ×
``seq`` (when ``num_seq > 1``) × ``model`` (when ``num_model > 1``), and a
rank's coordinates are its rank unravelled row-major over that shape, so
``model`` is innermost. With a process group the mesh is PyTorch's own
``init_device_mesh`` (NCCL on the card, gloo on the CPU); each axis's group
is the device mesh's, and the groups over several axes (the batch axes
``dcn`` × ``data``, the gradient axes) are made once here. Without a process
group the mesh has one process, every axis has size 1 and no group, and
every collective of the layouts is skipped, so each layout runs the same
code as the path without a mesh.

The JAX package's multi-process convention holds: every process holds the
same GLOBAL host batch and keeps only its own rows (``shard_batch``), and
every process builds the same parameters from the same seed
(``shard_params`` checks that they agree). A run at world size N therefore
computes what one process computes on the global batch.

Collectives, where JAX's GSPMD inserts them, are explicit here:
``all_reduce`` (data-parallel gradients, the tensor-parallel fc2 partial
sums, the SP frontend's dB reference), ``all_gather`` (data-parallel picks,
the SP ring's output), and point-to-point exchanges along ``seq``
(``exchange``: the SP BiLSTM's carries and the ring's payloads).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.config import MeshConfig

SEQ_AXIS = "seq"      # conventional name; never used for batch sharding
MODEL_AXIS = "model"  # tensor-parallel axis; never used for batch sharding


class Mesh:
    """This process's place on the device mesh: ``axis_names`` (outer to
    inner), ``shape`` (name → size), ``coords`` (name → this rank's index),
    ``device`` and, with a process group, ``device_mesh`` and one group per
    axis set that a layout reduces over (``group(axes)``; None without a
    process group)."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int], rank: int,
                 device: torch.device, device_mesh=None):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.rank = rank
        self.device = device
        self.device_mesh = device_mesh
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self._groups: dict[tuple[str, ...], Any] = {}

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=int))

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)], dtype=int))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` taken together (row-major)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def peer(self, axis: str, index: int) -> int:
        """Global rank of the process at ``index`` along ``axis`` with this
        rank's other coordinates."""
        coords = dict(self.coords, **{axis: index})
        return int(np.ravel_multi_index(tuple(coords[a] for a in self.axis_names),
                                        tuple(self.shape.values())))

    def group(self, axes):
        """The process group over ``axes`` (None without a process group)."""
        return self._groups.get(self._axes(axes))

    def _make_group(self, axes: tuple[str, ...]) -> None:
        """Make the group over ``axes`` (every rank calls this in the same
        order: group creation is collective)."""
        axes = self._axes(axes)
        if axes in self._groups or self.device_mesh is None:
            return
        if len(axes) == 1:
            self._groups[axes] = self.device_mesh.get_group(axes[0])
            return
        sizes = tuple(self.shape.values())
        keep = [a for a in self.axis_names if a not in axes]
        members: dict[tuple, list[int]] = {}
        for r in range(self.size):
            c = dict(zip(self.axis_names, np.unravel_index(r, sizes)))
            members.setdefault(tuple(int(c[a]) for a in keep), []).append(r)
        mine, _ = dist.new_subgroups_by_enumeration(list(members.values()))
        self._groups[axes] = mine

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def world() -> tuple[int, int]:
    """``(rank, world_size)`` of the default process group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(cfg: MeshConfig = MeshConfig(), device=None) -> Mesh:
    """Build the mesh over the processes of the default group (one device
    each; ``device`` defaults to the card, or to the CPU under a gloo group).

    Axes, outer→inner: ``dcn`` (if num_dcn>1) × ``data`` × ``seq`` (if
    num_seq>1) × ``model`` (if num_model>1), with the JAX package's name
    checks. Unlike the JAX package, a layout's axis stays on the mesh at
    size 1 when its flag asks for it (``seq`` under ``sp_audio``, ``model``
    under ``tp_vgg``): the layout then runs on one device with its
    collectives reduced to nothing, which is how one card runs it.
    ``num_data=-1`` takes the processes the other axes leave. Every process
    must be on the mesh: a process outside it would hold no device's work,
    so a mesh smaller than the world raises as one larger does."""
    if cfg.seq_axis != SEQ_AXIS:
        # _data_axes identifies the SP axis by name; renaming it would
        # silently shard the batch over the frame axis.
        raise ValueError(f"seq_axis must be {SEQ_AXIS!r}, got {cfg.seq_axis!r}")
    if cfg.model_axis != MODEL_AXIS:
        raise ValueError(f"model_axis must be {MODEL_AXIS!r}, got {cfg.model_axis!r}")
    rank, n_proc = world()
    num_seq = max(cfg.num_seq, 1)
    num_dcn = max(cfg.num_dcn, 1)
    num_model = max(cfg.num_model, 1)
    if cfg.num_data < 0:
        num_data = n_proc // (num_seq * num_dcn * num_model)
        if num_data < 1:
            raise ValueError(
                f"mesh needs num_dcn*num_seq*num_model = {num_dcn * num_seq * num_model} "
                f"devices, have {n_proc}")
    else:
        num_data = cfg.num_data
    n = num_dcn * num_data * num_seq * num_model
    if n > n_proc:
        raise ValueError(f"mesh {num_dcn}x{num_data}x{num_seq}x{num_model} needs {n} devices, "
                         f"have {n_proc}")
    if n < n_proc:
        raise ValueError(f"mesh {num_dcn}x{num_data}x{num_seq}x{num_model} holds {n} devices "
                         f"of the {n_proc} processes: each process drives one device of the mesh")
    shape, names = [], []
    if num_dcn > 1:
        shape.append(num_dcn)
        names.append(cfg.dcn_axis)
    shape.append(num_data)
    names.append(cfg.data_axis)
    if num_seq > 1 or cfg.sp_audio:
        shape.append(num_seq)
        names.append(cfg.seq_axis)
    if num_model > 1 or cfg.tp_vgg:
        shape.append(num_model)
        names.append(cfg.model_axis)
    return mesh_from_axes(names, shape, device)


def mesh_from_axes(names: Sequence[str], sizes: Sequence[int], device=None) -> Mesh:
    """The mesh of the given axes (outer to inner) over the processes of the
    default group, with a group for each axis, for the batch axes and for
    the gradient axes; every process calls it alike (group creation is
    collective); the caller has checked that the axes hold every process.
    ``device`` defaults to the card, or to the CPU under a gloo group."""
    rank = world()[0]
    if device is None:
        gloo = dist.is_available() and dist.is_initialized() and dist.get_backend() == "gloo"
        device = "cpu" if gloo else "cuda"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    device_mesh = None
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(dev.type, tuple(sizes), mesh_dim_names=tuple(names))
    mesh = Mesh(names, sizes, rank, dev, device_mesh)
    for a in names:
        mesh._make_group((a,))
    mesh._make_group(_data_axes(mesh))
    mesh._make_group(grad_axes(mesh))
    return mesh


def _data_axes(mesh: Mesh) -> tuple[str, ...]:
    """All mesh axes that shard the batch (dcn × data when 2-level); the
    ``seq`` axis shards the audio frame axis and the ``model`` axis shards
    TP weight matrices instead — never the batch."""
    return tuple(a for a in mesh.axis_names if a not in (SEQ_AXIS, MODEL_AXIS))


def grad_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes a training step sums its gradients over: every axis but
    ``model``, whose ranks hold the same rows and compute the same towers.
    Ranks along ``seq`` each hold a share of the SP audio tower's work."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def data_shard_count(mesh: Mesh) -> int:
    """Number of ways the batch dim shards on this mesh (product of the
    data axes; ``seq``/``model`` never carry the batch)."""
    return mesh.axis_size(_data_axes(mesh))


def batch_rows(mesh: Mesh, batch_size: int) -> tuple[int, int] | None:
    """``(start, stop)`` of the global batch rows this rank holds, or None
    when the data axes do not divide ``batch_size`` (every rank holds every
    row)."""
    n = data_shard_count(mesh)
    if batch_size % n:
        return None
    per = batch_size // n
    i = mesh.axis_index(_data_axes(mesh))
    return i * per, (i + 1) * per


def local_batch_rows(mesh: Mesh, batch_size: int) -> np.ndarray | None:
    """Global batch rows this process holds, or None when one process holds
    them all (a single process, or rows that do not divide the mesh) — the
    rows the host must decode."""
    if world()[1] == 1:
        return None
    rows = batch_rows(mesh, batch_size)
    return None if rows is None else np.arange(*rows, dtype=np.int64)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> dict:
    """This rank's rows of every array of the GLOBAL batch, on the mesh's
    device (numpy arrays are cut before the upload). An array whose leading
    dim the data axes do not divide is kept whole on every rank — correct,
    just not parallel; a leading dim past the shard count warns, since that
    is a typo'd batch size running ``n``× slower."""
    n = data_shard_count(mesh)

    def place(k, v):
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if t.dim() > 0 and t.shape[0] % n == 0:
            start, stop = batch_rows(mesh, t.shape[0])
            t = t[start:stop]
        elif t.dim() > 0 and t.shape[0] > n:
            warnings.warn(
                f"shard_batch: '{k}' leading dim {t.shape[0]} does not divide the {n}-way data "
                f"axes; every rank keeps every row (runs {n}x slower). Size the batch as a "
                f"multiple of {n}.", stacklevel=3)
        return t.to(mesh.device)

    return {k: place(k, v) for k, v in batch.items()}


def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``t`` summed (or ``op``) in place over ``group``; no group, no call."""
    if group is not None:
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def exchange(sends: Sequence[tuple[torch.Tensor, int]], recvs: Sequence[tuple[torch.Tensor, int]],
             group) -> None:
    """One batch of point-to-point sends and receives (``(tensor, global
    peer rank)``) along ``group``, waited on before it returns."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer, group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _check_replicas(tensors: Sequence[torch.Tensor], mesh: Mesh, what: str) -> None:
    """Raise unless every rank holds the same values: the per-tensor sums
    of squares and sums in f64, their minimum and maximum over the world."""
    if mesh.device_mesh is None or not tensors:
        return
    group = dist.group.WORLD
    sig = torch.stack([torch.stack([t.detach().double().sum(), t.detach().double().square().sum()])
                       for t in tensors]).reshape(-1).to(mesh.device)
    lo, hi = sig.clone(), sig.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise ValueError(f"shard_params: the ranks hold different {what} (build them from the "
                         "same seed or checkpoint on every rank)")


def shard_params(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replicate ``module`` over the mesh: moved to the mesh's device, after a
    check that every rank passed the same values (init is seed-deterministic)."""
    module = module.to(mesh.device)
    _check_replicas(list(module.parameters()) + list(module.buffers()), mesh, "parameters")
    return module


class ModelShard:
    """Set on a VGG module by ``shard_frontend(tp_vgg=True)``: its fc1 holds
    this rank's columns and its fc2 this rank's rows, and ``vgg_features``
    all-reduces fc2's partial product over ``group``. Copies of the module
    share it."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.group)


def shard_frontend(frontend, mesh: Mesh, tp_vgg: bool = False):
    """Place the frozen frontend; with ``tp_vgg`` the VGG classifier is
    tensor-parallel over the mesh's ``model`` axis, Megatron-style:

    - ``fc1_w [flat, fc]`` column-parallel (each rank its ``fc/n`` columns),
      ``fc1_b`` likewise; fc1→ReLU stays local to the rank;
    - ``fc2_w [fc, fc]`` row-parallel (each rank its ``fc/n`` rows): the
      partial products are all-reduced once over ``model``, then ``fc2_b``
      and ReLU — one collective for the classifier.

    Each rank moves only its own slices to the device; the convs and the
    audio constants replicate."""
    import copy

    if not tp_vgg:
        return shard_params(frontend, mesh)
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError("tp_vgg needs a 'model' mesh axis: set MeshConfig.num_model > 1")
    vgg = getattr(frontend, "vgg", None)
    if vgg is None:
        raise ValueError("tp_vgg shards the VGG classifier but the frontend has no 'vgg' "
                         "params (image tower disabled?)")
    if getattr(vgg, "tp", None) is not None:
        raise ValueError("shard_frontend: this frontend's VGG classifier is split already")
    n = mesh.shape[MODEL_AXIS]
    fc_dim = int(vgg.fc1_w.shape[1])
    if fc_dim % n:
        raise ValueError(f"tp_vgg: the model axis ({n}) must divide fc_dim {fc_dim}; "
                         f"pick num_model from the divisors of {fc_dim}")
    _check_replicas(list(frontend.parameters()), mesh, "frontend weights")
    k = mesh.coords[MODEL_AXIS]
    lo, hi = k * fc_dim // n, (k + 1) * fc_dim // n
    full = {"fc1_w": vgg.fc1_w, "fc1_b": vgg.fc1_b, "fc2_w": vgg.fc2_w}
    # the copy leaves the split leaves out, so no whole classifier is copied
    out = copy.deepcopy(frontend, memo={id(p): None for p in full.values()}).to(mesh.device)
    local = {"fc1_w": full["fc1_w"][:, lo:hi], "fc1_b": full["fc1_b"][lo:hi],
             "fc2_w": full["fc2_w"][lo:hi]}
    for name, t in local.items():
        setattr(out.vgg, name, torch.nn.Parameter(t.contiguous().to(mesh.device),
                                                  requires_grad=False))
    out.vgg.tp = ModelShard(mesh.group(MODEL_AXIS))
    return out


def initialize_distributed(device="cuda") -> bool:
    """Start the default process group when the environment names one, and
    return whether a group is running. It reads torchrun's ``RANK`` /
    ``WORLD_SIZE`` (with ``MASTER_ADDR`` / ``MASTER_PORT``), or the JAX
    package's ``COORDINATOR_ADDRESS`` (or ``JAX_COORDINATOR_ADDRESS``) with
    ``NUM_PROCESSES`` / ``PROCESS_ID`` (``host:port``, or any
    ``init_process_group`` URL such as ``file://``). NCCL on a CUDA device
    (the process takes ``cuda:LOCAL_RANK``), gloo on the CPU. False when
    none of these are set."""
    if dist.is_initialized():
        return True
    env = os.environ
    addr = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    if "RANK" in env and "WORLD_SIZE" in env:
        init, rank, size = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
    elif addr:
        nproc = env.get("NUM_PROCESSES") or env.get("JAX_NUM_PROCESSES")
        pid = env.get("PROCESS_ID") or env.get("JAX_PROCESS_ID")
        if nproc is None or pid is None:
            raise ValueError("COORDINATOR_ADDRESS needs NUM_PROCESSES and PROCESS_ID")
        init = addr if "://" in addr else f"tcp://{addr}"
        rank, size = int(pid), int(nproc)
    else:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            rank=rank, world_size=size)
    return True
