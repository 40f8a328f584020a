"""Experiments of the port: the held-out quality run and the tower ablation."""
