from vs_seg.train.trainer import (
    Trainer, make_optimizer, make_train_step, make_eval_step, init_model,
    to_device_batch,
)
from vs_seg.train.checkpoint import save_checkpoint, load_checkpoint
