from .attention import attention_reference, fused_spatial_attention
from .fast_conv import conv_transpose_5x5_s2, fused_dual_downsample
from .resize import nearest_resize
