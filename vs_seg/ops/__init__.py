from vs_seg.ops.experimental.grouped_conv import grouped_conv2d, build_block_toeplitz
