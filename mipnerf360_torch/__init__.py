"""mipnerf360_torch — the PyTorch/CUDA port of ``mipnerf360_tpu`` for NVIDIA Hopper.

It keeps the JAX package's module layout so each function has a named
counterpart there, and imports neither ``jax`` nor ``mipnerf360_tpu``. Plain
tensor code is PyTorch; the TPU's Pallas kernels become hand-written CUDA
kernels for ``sm_90a`` (``csrc/``, bound in ``ops/``). Entry points run on the
card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import Config, ModelConfig, TrainConfig, DataConfig, MeshConfig, get_config
