from .charbonnier import charbonnier_loss
from .color import angular_color_loss
from .composite import CompositeLossConfig, composite_enhancement_loss
from .ms_ssim import ms_ssim, ms_ssim_loss
from .perceptual import DinoPerceptualLoss, VGGPerceptualLoss
