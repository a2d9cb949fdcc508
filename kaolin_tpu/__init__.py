"""kaolin_tpu — a 3D deep learning framework in JAX.

A from-scratch re-design of the capabilities of NVIDIA Kaolin v0.14.0 in
JAX, run on NVIDIA GPUs (and on the CPU for tests): differentiable
rasterization (DIB-R), volumetric rendering (DefTet), structured point
clouds (SPC) with octree ray tracing and sparse convolutions, a
differentiable camera API, SH/SG lighting, mesh/pointcloud/voxelgrid ops
and conversions, 3D metrics, dataset I/O, training checkpoints
(Timelapse) and visualization.

Compute path: jax / XLA / Pallas (Triton route for the DIB-R kernels).  Batched containers are pytrees; CUDA
autograd Functions become `jax.custom_vjp` or stop-grad-selection +
differentiable-epilogue ops; CUB sort/scan become `lax.sort` /
`associative_scan` / `segment_sum`; atomics become scatter-adds.

Reference layer map: see SURVEY.md §1 (reference `kaolin/__init__.py:1-12`).
"""

__version__ = "0.1.0"

from kaolin_tpu import io  # noqa: F401
from kaolin_tpu import metrics  # noqa: F401
from kaolin_tpu import ops  # noqa: F401
from kaolin_tpu import render  # noqa: F401
from kaolin_tpu import rep  # noqa: F401
from kaolin_tpu import utils  # noqa: F401
from kaolin_tpu import visualize  # noqa: F401
from kaolin_tpu import parallel  # noqa: F401
