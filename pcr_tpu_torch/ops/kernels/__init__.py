"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper runs its plain version for tensors on the CPU and launches its
CUDA kernel for tensors on a CUDA device; it never falls back from one to the
other.  ``LAUNCHES`` in each module counts kernel launches.
"""
