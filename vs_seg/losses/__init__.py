from vs_seg.losses.dice import (
    dice_loss, dice_spvpa_loss, masked_dice_loss, generalized_dice_loss,
    generalized_wasserstein_dice_loss, one_hot,
)
