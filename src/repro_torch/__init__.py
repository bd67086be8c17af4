"""PyTorch + CUDA port of the DiLoCo reproduction (``src/repro/``).

The JAX package is the reference; this package mirrors its layout
(``configs``, ``kernels``, ``models``, ``optim``, ``core``, ``data``,
``launch``, ``obs``) module by module. It imports ``torch``, numpy and the
standard library only. Parameters are nested dicts of tensors with the JAX
tree's key paths; every kernel that the JAX package wrote in Pallas for
the TPU is a hand-written CUDA kernel here (``kernels/csrc``), with its
plain PyTorch version beside it.
"""
