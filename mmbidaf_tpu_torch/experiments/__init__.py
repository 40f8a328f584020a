"""Experiments of the port: the held-out quality run, the tower ablation, and
the A/B and profiling drivers (each ``python -m
mmbidaf_tpu_torch.experiments.<name>``, one JSON line a measurement)."""
