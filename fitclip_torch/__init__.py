"""fitclip_torch: the PyTorch port of fitclip_tpu for one NVIDIA H100.

The int8 CLIP zero-shot encoding path runs on hand-written Hopper kernels
(``csrc/``, built on first use by ``_build.py``); every kernel has a plain
PyTorch version beside it that CPU tensors take. The package imports torch,
numpy and the standard library, never JAX.
"""
