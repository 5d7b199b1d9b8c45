from vs_seg.nn.layers import Conv3d, ConvTranspose3d, BatchNorm, PReLU, Dropout
from vs_seg.nn.blocks import Convolution, ResidualUnit, AttentionBlock1, attention_gate
