"""spherical_bundle_adjuster_tpu_torch: the PyTorch + CUDA port of
spherical_bundle_adjuster_tpu, for one NVIDIA H100 (sm_90a).

The JAX package beside it is the reference; this package mirrors its
layout (core/ ops/ models/ solver/ utils/) and its module and function
names. It imports torch and nothing of jax or of the reference package.
Its configuration dataclasses (utils/config.py) are its own copy of the
reference's, with the same field names and defaults less five TPU-only
knobs; `config.from_reference` converts a reference config.

The three Pallas TPU kernels of the reference become hand-written CUDA
C++ kernels under csrc/ (ops/cuda_surf.py, ops/cuda_match.py), built with
nvcc at first use. Each has a plain PyTorch version beside it that runs
for CPU tensors only.
"""

__version__ = "0.1.0"

from .core import precision  # noqa: F401  (turns TF32 off)
from .utils.config import PipelineConfig  # noqa: F401
