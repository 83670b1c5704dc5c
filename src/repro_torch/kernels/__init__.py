"""Kernel layer: plain PyTorch versions (``ref``), hand-written CUDA kernels
for Hopper (``csrc``, bound in ``sim_best_edge``, ``assign_stats`` and
``assign_argmax``) and the dispatch between them (``ops``), which core code
calls."""
