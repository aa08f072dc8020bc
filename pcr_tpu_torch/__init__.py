"""pcr_tpu_torch — the PyTorch/CUDA port of ``pcr_tpu`` for NVIDIA Hopper.

The JAX package ``pcr_tpu`` stays the reference; this package mirrors its
module paths and function names.  Ported so far: stage 2 (multi-scale GICP
over per-cloud pyramids) on the streamed single-pair path of
``pipeline.run_stage2_mgicp``.  The three Pallas kernels that path runs are
hand-written CUDA kernels here (``csrc/``, bound in ``ops/kernels/``); on CPU
tensors every wrapper runs its plain PyTorch version instead.

Importing this package never imports ``jax`` or ``pcr_tpu``.
"""

import torch

# Squared-distance ranking needs true-f32 products (the counterpart of
# pcr_tpu/__init__.py's "highest" matmul precision): TF32 keeps ~3 decimal
# digits, far coarser than the millimetre neighbour gaps at LiDAR coordinates.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from . import utils  # noqa: F401,E402

__version__ = "0.1.0"
