"""pcr_tpu_torch — the PyTorch/CUDA port of ``pcr_tpu`` for NVIDIA Hopper.

The JAX package ``pcr_tpu`` stays the reference; this package mirrors its
module paths and function names.  Ported so far: stage 1 (banded normals
+ FPFH, mutual feature matching, the tuple test and GNC) and stage 2
(multi-scale GICP over per-cloud pyramids), on the streamed single-pair
paths of ``pipeline.run_stage1_fgr`` and ``pipeline.run_stage2_mgicp``.
The six Pallas kernels those paths run (K1-K6) are hand-written CUDA
kernels here (``csrc/``, bound in ``ops/kernels/``); on CPU tensors every
wrapper runs its plain PyTorch version instead.  Clouds are built on the
CUDA card unless the caller asks for the CPU.

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
