"""repro_torch — the PyTorch / CUDA port of the ABFP reproduction.

Mirrors the layout of the JAX package ``repro`` (configs, core, kernels,
models, serving, training, optim, data, checkpoint, distributed, launch)
and imports nothing from it.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; on the CPU
every kernel wrapper runs its plain PyTorch version.
"""
