"""Loss layer (counterpart of ``mipnerf360_tpu/losses``): distillation,
distortion, photometric."""
from .distillation import weight_bounds, proposal_loss, distillation_loss
from .distortion import distortion_loss, distortion_loss_quadratic
from .photometric import photometric_loss, mse_to_psnr, psnr_to_mse
