"""pcr_tpu_torch — the PyTorch/CUDA port of ``pcr_tpu`` for NVIDIA Hopper.

The JAX package ``pcr_tpu`` stays the reference; this package mirrors its
module paths and function names.  Ported: the entry points
(``python -m pcr_tpu_torch stage1|stage2|stage3|full|pair|report``, dataset
loading through the native PCD reader of ``native/``, ``LazyClouds``,
``pipeline.run_pair``, ``viz``), stages 1, 2 and 3 and ``pipeline.run_full``
(stages 1 -> 3 in one window, the main path), the staged runners at every
``batch_size`` on one card, and the device meshes (``parallel/`` on
``torch.distributed``, one process a device: ``mesh=`` of the staged
runners, ``point_mesh=`` of ``run_pair``, the CLI's ``--devices`` and
``--shard-points``), and the k-connectivity pose-graph builder
(``models/graph_builder``) with its extras (``models/features``,
``models/manual``).  The seven Pallas kernels those paths run (K1-K7) are
hand-written CUDA kernels here (``csrc/``, bound in ``ops/kernels/``), and
so are four programs that ``pcr_tpu`` compiles with XLA: FGR's GNC (K8),
the pose graph's block-Thomas solve (K9), FGR's mutual feature matching
(K11) and the pose graph's edge Jacobians, blocks and their assembly (K12);
on CPU tensors every wrapper runs its plain PyTorch version instead.  Clouds
and loaded scans go to the CUDA card unless the caller asks for the CPU.

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
