"""LM model zoo of the port: the dense, vlm, encdec, moe, hybrid (Mamba2) and
rwkv (RWKV-6) families of the JAX package's ``models``, as ``nn.Module``s
whose parameters keep the reference's names.
"""
