"""scl_slam_tpu_torch — the PyTorch + CUDA port of ``scl_slam_tpu``.

A second package beside the JAX one, held against it by the parity tests
(``tests/test_torch_*.py``). It keeps the JAX package's module paths and
function names so each counterpart is easy to find. Plain tensor code is
PyTorch; the TPU's Pallas kernels on the ported path are hand-written CUDA
C++ (``csrc/``, bound in ``ops/kernels.py``). This package never imports
``jax``.

Ported so far: the keyframe replay path (``Mapper.replay``), the live
single-robot path (``Mapper.add_frame`` / ``spin_once`` / ``optimize``,
driven by ``python -m scl_slam_tpu_torch.run``) and the pose-graph solve.
``Mapper`` runs on the GPU unless it is given ``device="cpu"``. What is
still to come is listed in ``ROADMAP.md``.
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of scl_slam_tpu's jax_default_matmul_precision="highest": the
# retrieval einsums, the Kabsch cross-covariance and the pose algebra must
# stay full f32 (TF32 keeps ~3 decimal digits — at map-scale coordinates
# that randomizes nearest-neighbor choices and rotations).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import DescriptorType, SlamConfig, load_config  # noqa: E402
from .geometry import Pose  # noqa: E402

__all__ = ["SlamConfig", "DescriptorType", "load_config", "Pose", "Mapper"]


def __getattr__(name):
    # lazy: runtime pulls in the whole stack; keep a bare import light
    if name == "Mapper":
        from .runtime import Mapper

        return Mapper
    raise AttributeError(name)
