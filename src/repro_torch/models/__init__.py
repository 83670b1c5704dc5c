"""LM model zoo of the port: the dense, vlm and encdec families of the JAX
package's ``models``, as ``nn.Module``s whose parameters keep the
reference's names. The moe, hybrid and rwkv families are not ported yet.
"""
