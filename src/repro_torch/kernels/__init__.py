"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the module that compiles them (``build.py``)."""
