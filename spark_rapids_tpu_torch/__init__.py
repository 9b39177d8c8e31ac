"""spark_rapids_tpu_torch: the PyTorch/CUDA port of spark_rapids_tpu.

The tree mirrors the JAX package path for path (columnar/, ops/, plan/,
api/, config.py). The port imports torch and numpy, never jax and nothing
of spark_rapids_tpu. Its hand-written CUDA kernels live in csrc/ and are
built at first use by native.py; each has a plain PyTorch twin beside its
wrapper, used only for tensors on the CPU.

Entry point: ``spark_rapids_tpu_torch.api.session.TpuSession``.
"""
