"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain
PyTorch versions.  Importing a module here builds nothing: the kernels are
compiled by ``_build`` at their first launch."""
