"""orb_slam_2_ros_tpu_torch — the PyTorch + CUDA port of orb_slam_2_ros_tpu.

The JAX package ``orb_slam_2_ros_tpu`` stays the reference; this package
mirrors its layout (``geometry/``, ``ops/``, ``frontend/``, ``solvers/``,
``map/``, ``pipeline/``) and keeps its public function names and array
layouts, so each module can be checked against its counterpart. It imports
``torch`` and never ``jax``. The only pieces of the reference it reuses are
jax-free: the configuration dataclasses (``config.py``) and the synthetic
sequences and trajectory metrics (``io.py``).

Descriptors are ``(N, 8) int32`` words carrying the same bits as the
reference's ``uint32`` words. The matcher's fused best-two search is a CUDA
kernel (``csrc/masked_best_two.cu``) built at first use by ``_build.py``.

Accuracy of the pose solver rests on exact float32 normal equations, so the
package turns TF32 off for matmuls and cuDNN when it is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
