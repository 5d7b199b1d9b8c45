from vs_seg.eval.metrics import dice_score, center_of_mass_slice
