from .cfg_unet import CFGUNet
from .unet import DynamicUNet
