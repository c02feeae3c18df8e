"""PyTorch/CUDA port of the padding-free fp8 grouped GEMM stack, for
NVIDIA Hopper.  It imports torch and never jax, and nothing of the JAX
package ``repro``, which stays the reference it is tested against.

The router's f32 matmul decides the routing, so f32 matmuls must be real
f32: TF32 is switched off for the whole process on import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
