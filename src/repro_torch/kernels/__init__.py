"""Hand-written CUDA kernels for DiLoCo's hot path, and their plain
PyTorch versions.

csrc/fused_adamw.cu     inner AdamW step, one pass (replaces the Pallas
                        kernels/fused_adamw.py:fused_adamw)
csrc/outer_nesterov.cu  outer Nesterov step, one pass (replaces the
                        Pallas kernels/outer_nesterov.py:outer_nesterov)
fused_adamw.py,         wrappers: kernel on CUDA tensors, plain version
outer_nesterov.py       on CPU tensors, launch counters
ref.py                  the plain PyTorch versions
ops.py                  kernel_mode dispatch and tree-level updates
build.py                nvcc build into build/repro_torch_kernels, ctypes
"""
