"""The model (counterpart of ``mipnerf360_tpu/models``)."""
from .mlp import apply_mlp, init_mlp
from .mipnerf360 import (MipNeRF360, RenderNoise, init_model, map_params,
                         nerf_forward, prop_forward, render_image, render_rays)
