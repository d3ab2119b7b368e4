"""Host-side data (counterpart of ``mipnerf360_tpu/data``): the synthetic
scene so far."""
from .base import RayDataset, flatten_images
from .rays_gen import pinhole_rays
from .synthetic import synthetic_dataset
