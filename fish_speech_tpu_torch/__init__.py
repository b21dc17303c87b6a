"""PyTorch/CUDA port of fish_speech_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (models/, ops/, codec/, text/, engine/).
The port imports torch and nothing of JAX or of the JAX package. The four
kernels of the serving path are hand-written CUDA C++ under csrc/, built by
nvcc at first use (ops/_cuda.py); each has a plain PyTorch twin in its ops
module, which runs only for CPU tensors.
"""
