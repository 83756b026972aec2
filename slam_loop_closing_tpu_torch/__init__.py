"""slam_loop_closing_tpu_torch — the PyTorch / CUDA port of
:mod:`slam_loop_closing_tpu`, for one NVIDIA H100.

The JAX package stays the reference: every public function here keeps its
counterpart's layouts (``[B, H, W]`` float32 frames in [0, 1], ``[K, 2]``
(x, y) keypoints, ``[N, 256]`` int8 +-1 descriptors with invalid rows zero)
so tests can hold the two against each other on the same numpy inputs.

* ``ops``    — image pyramid, FAST, ORB, descriptor layouts, band matching.
               The TPU's Pallas kernels on this path are hand-written CUDA
               (``csrc/``), wrapped in :mod:`.ops.cuda_kernels`.
* ``models`` — ``LoopClosingSystem`` (Version A: batched, live and
               multi-video), ``SfMPipeline`` (Version B), chessboard
               calibration.
* ``utils``  — kernel build/load, synthetic video, frame IO and the report
               writers, the KITTI adapter, stage timing and traces,
               conversion of the JAX package's arrays.
* ``cli``    — ``extract | loop | all | reconstruct | calibrate``.

This package imports ``torch`` and numpy, never ``jax``.
"""

import torch as _torch

# Full-float32 products everywhere (the JAX package's
# ``jax_default_matmul_precision=highest``): TF32 keeps ~3 decimal digits,
# and cuDNN would otherwise run float32 convolutions in TF32 by default.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from slam_loop_closing_tpu_torch import config as config  # noqa: E402

__version__ = "0.1.0"

__all__ = ["config", "__version__"]
