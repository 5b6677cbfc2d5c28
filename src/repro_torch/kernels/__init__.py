"""Kernels of the port: K1 (hadacore), K2 (fused_quant), their plain
versions, the backend registry and the CUDA build."""
