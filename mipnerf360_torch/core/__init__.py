"""Geometry, encoding, sampling and compositing on tensors (counterpart of
``mipnerf360_tpu/core``)."""
from .rays import (Rays, rays_map, rays_to_device, flatten_rays, take_rays,
                   dummy_rays, resolve_device)
from .spacing import g, t_to_s, s_to_t
from .contract import contract, contract_jacobian, contract_gaussian
from .gaussians import (
    conical_frustum_to_gaussian,
    cylinder_to_gaussian,
    lift_gaussian,
    cast_rays,
)
from .encoding import integrated_pos_enc, viewdir_enc, viewdir_enc_dim, P_BASIS, POS_ENC_DIM
from .fused_encode import factored_ipe
from .sampling import (
    sorted_piecewise_constant_pdf,
    sample_along_rays,
    resample_along_rays,
    blur_weights,
)
from .rendering import volumetric_rendering, compute_alpha_weights, composite_outputs
