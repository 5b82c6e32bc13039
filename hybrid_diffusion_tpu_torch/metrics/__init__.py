from .color import rgb2gray, rgb2lab
from .psnr_ssim import psnr, ssim_index
from .uiqm import eme, getUIQM, logamee, nmetrics, uciqe, uicm, uiconm, uism
from .fid import FID, StreamingFID, InceptionV3Features
