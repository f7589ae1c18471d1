"""Device-side compute core: pure JAX ops, runnable unchanged on CPU and GPU.

This is the analog of the reference's `kernels/` crate: one pure
compute path with two execution backends (reference: kernels/src/lib.rs:21
is a single function called from both SPIR-V and the CPU driver). Here
the same property holds via JAX: every op is traceable and jit-compiles
for GPU or CPU without modification (the one exception, the GPU scan
kernel in ops/scan.py, has the brute-force engine as its CPU twin).
"""
