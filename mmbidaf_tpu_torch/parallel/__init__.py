"""Mesh layouts over ``torch.distributed`` — the port of ``mmbidaf_tpu.parallel``:
the device mesh with data parallelism and the VGG classifier's tensor
parallelism (``mesh.py``), and the sequence-parallel audio tower
(``audio_sp.py`` → ``sp_lstm.py`` → ``ring_attention.py``, wired by
``sp_tower.py``). Importing the package imports ``mesh.py`` alone (a mesh
artifact's loader needs no model code); the SP modules load on first use."""

from mmbidaf_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_shard_count,
    initialize_distributed,
    local_batch_rows,
    make_mesh,
    shard_batch,
    shard_frontend,
    shard_params,
)


def __getattr__(name: str):
    if name == "make_sp_bilstm":
        from mmbidaf_tpu_torch.parallel.sp_lstm import make_sp_bilstm

        return make_sp_bilstm
    if name == "make_sp_audio_tower":
        from mmbidaf_tpu_torch.parallel.sp_tower import make_sp_audio_tower

        return make_sp_audio_tower
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
