"""Mesh layouts over ``torch.distributed`` — the port of ``mmbidaf_tpu.parallel``:
the device mesh with data parallelism and the VGG classifier's tensor
parallelism (``mesh.py``), and the sequence-parallel audio tower
(``audio_sp.py`` → ``sp_lstm.py`` → ``ring_attention.py``, wired by
``sp_tower.py``)."""

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
from mmbidaf_tpu_torch.parallel.sp_lstm import make_sp_bilstm  # noqa: F401
from mmbidaf_tpu_torch.parallel.sp_tower import make_sp_audio_tower  # noqa: F401
