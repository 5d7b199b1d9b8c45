from vs_seg.compat.torch_import import import_unet2d5_spvpa, load_pth
