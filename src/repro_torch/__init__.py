"""PBS set reconciliation in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper — the port of the JAX package ``repro``, held against it bit
for bit.  Sub-packages mirror the reference: ``core`` (numpy protocol
oracle), ``kernels`` (CUDA kernels + plain versions), ``recon`` (batched
multi-session engine), ``obs`` (metrics + tracing).
"""
