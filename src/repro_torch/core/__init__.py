"""Differentiable fp8 grouped GEMM, quantization and the MoE layer."""
