"""gsplat_tpu_torch — the PyTorch/CUDA port of `gsplat_tpu`.

A second package beside the JAX one, with the same public functions, held
against it by `tests/test_torch_*.py`. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package becomes a CUDA C++ kernel for Hopper
(`sm_90a`) under `csrc/`, built by `nvcc` at first use (`_kernels.py`).
Each kernel has a plain PyTorch twin in the same module; a wrapper takes the
twin only for CPU tensors.

The port imports neither `jax` nor `gsplat_tpu`. Entry points run on `cuda`
unless the caller passes `device="cpu"`.
"""
