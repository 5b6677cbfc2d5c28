"""Timing harnesses of the port's kernels on one CUDA card (the port's
own benches; ``benchmarks/`` belongs to the JAX reference)."""
