"""Hand-written Hopper kernels (CUDA C++ under ``mmbidaf_tpu_torch/csrc``) and
their Python wrappers. Each wrapper module holds the plain PyTorch version of
its kernel's function beside it; on a CPU tensor the wrapper runs that plain
version, on a CUDA tensor it launches the kernel or raises."""
