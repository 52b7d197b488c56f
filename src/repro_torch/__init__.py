"""PyTorch + CUDA port of the Gimbal MoE serving data plane.

A second package beside the JAX reference ``repro``: same module layout and
names, PyTorch tensors instead of JAX arrays, and a hand-written Hopper
kernel (``csrc/*.cu``) in place of every Pallas kernel on the serving path.
It never imports ``jax`` or anything of ``repro``; the pure-Python control
plane it needs is kept here as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU each kernel wrapper runs its plain PyTorch version.
"""
