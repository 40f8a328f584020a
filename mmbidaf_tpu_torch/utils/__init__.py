"""Counting, timing and tracing helpers of the port (``flops``,
``profiling``) and the benchmark's configuration (``bench_config``)."""
