from .unet import DynamicUNet
