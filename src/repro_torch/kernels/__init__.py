"""Hand-written CUDA kernels for DiLoCo's hot path, and their plain
PyTorch versions.

csrc/fused_adamw.cu     inner AdamW step, one pass, f32 or bf16 storage,
                        and the mixed step from an f32 master (replaces
                        the Pallas kernels/fused_adamw.py:fused_adamw and
                        fused_adamw_mixed)
csrc/outer_nesterov.cu  outer Nesterov step, one pass (replaces the
                        Pallas kernels/outer_nesterov.py:outer_nesterov)
csrc/flash_attention.cu flash attention forward (with and without the
                        logsumexp), dq and dk/dv, all on the tensor
                        cores in split TF32 (replaces the Pallas
                        kernels/flash_attention.py)
csrc/sign_prune.cu      per-row sign election and bisection threshold of
                        outer gradients (replaces the Pallas
                        kernels/sign_prune.py:sign_prune)
csrc/quantize.cu        int4 or bf16 quantize→dequantize round trip of
                        outer gradients, and the packed int4 wire's
                        sender and receiver (replaces the Pallas
                        kernels/quantize.py:fake_quant,
                        quantize_pack_int4, unpack_dequantize_int4)
fused_adamw.py,         wrappers: kernel on CUDA tensors, plain version
outer_nesterov.py,      on CPU tensors, launch counters; flash attention's
flash_attention.py,     is also a torch.autograd.Function
sign_prune.py,
quantize.py
ref.py                  the plain PyTorch versions
ops.py                  kernel_mode dispatch, tree-level updates, attention
build.py                nvcc build into build/repro_torch_kernels, ctypes
"""
