"""scl_slam_tpu_torch — the PyTorch + CUDA port of ``scl_slam_tpu``.

A second package beside the JAX one, held against it by the parity tests
(``tests/test_torch_*.py``). It keeps the JAX package's module paths and
function names so each counterpart is easy to find. Plain tensor code is
PyTorch; the TPU's Pallas kernels on the ported path are hand-written CUDA
C++ (``csrc/``, bound in ``ops/kernels.py``). This package never imports
``jax``.

Ported so far: the keyframe replay path (``Mapper.replay``), the live
single-robot path (``Mapper.add_frame`` / ``add_frames`` / ``spin_once`` /
``optimize``, driven by ``python -m scl_slam_tpu_torch.run``), the
pose-graph solve, the decentralized inter-robot path (descriptors over a
bus, RANSAC verification by RPC, driven by ``python -m
scl_slam_tpu_torch.run_multi``), the centralized fleet (``FleetMapper``,
batched RANSAC; ``run_multi --fleet``) with keyframe eviction
(``runtime/eviction.py``), and the JAX package's batched-ICP switches
(``FUSED_ICP``, ``NN_INDEX``, ``MXU_NN``, ``SELECT_VARIANT`` in
``ops/registration.py``). Every TPU kernel has its CUDA counterpart; the
batched 1-NN (K1, K7, K8), the solo 1-NN (K4, K3) and the fused ICP
moments (K5) run one kernel that splits the target axis across the card
(``csrc/nn_split.cuh``). The quality anchor (``python -m
scl_slam_tpu_torch.bench_quality``) replays 1,224 keyframes of the LiDAR
simulator's urban world (``io/lidar_sim.py``) against the JAX package's
golden ATE bound; the voxel storage modes, PCM outlier rejection in the
drain (``graph/pcm.py``) and the exact chain + loop solver
(``graph/chain_solver.py``) are ported too, and so are checkpoint / resume
(``runtime/checkpoint.py``, the JAX package's file layout; ``run_robot
--resume``, ``run_multi --respawn``) and the serving daemon (``python -m
scl_slam_tpu_torch.serve``, with ``io/export.py``), and so is the front end:
point-to-plane scan-to-map odometry with deskew (``runtime/odometry.py``,
``ops/deskew.py``; its 1-NN on K4), IMU preintegration (``runtime/imu.py``)
and the 15-state IMU window smoother (``graph/imu_factor.py``), behind
``run --odometry icp|imu`` and ``serve --odometry icp``. The I/O modules
(the Euler and quaternion conversions, the C++ prefetching loader behind
``run --loader native``, the run figures) and the distributed path on
``torch.distributed`` (``parallel/``: the edge-sharded solve behind
``Mapper.attach_mesh``, the row-sharded descriptor DB behind
``Mapper.shard_database``, the multi-rank dry run) complete the port;
``ROADMAP.md`` lists what is not carried. ``Mapper`` runs on the GPU
unless it is given ``device="cpu"``.
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
