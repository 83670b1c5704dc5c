"""PyTorch/CUDA port of the big-text clustering system (``repro``).

The JAX package ``repro`` is the reference; this package computes the same
algorithms with PyTorch around hand-written CUDA kernels for Hopper
(``kernels/csrc``). Entry points that create tensors run on the CUDA device
unless the caller passes ``device="cpu"``; functions that take tensors run
where those tensors lie.
"""
