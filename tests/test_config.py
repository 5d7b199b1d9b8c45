import numpy as np

from vs_seg.core.config import Config, add_reference_cli_flags, config_from_args


def _parse(argv):
    import argparse
    parser = argparse.ArgumentParser()
    add_reference_cli_flags(parser)
    return config_from_args(parser.parse_args(argv))


def test_reference_cli_defaults():
    cfg = _parse([])
    # reference defaults (params/VSparams.py:39-112)
    assert cfg.dataset == "T1"
    assert cfg.split_csv == "./params/split_TCIA.csv"
    assert cfg.train_batch_size == 1
    assert cfg.initial_learning_rate == 1e-4
    assert cfg.attention and cfg.hardness
    assert cfg.num_epochs == 300
    assert cfg.epochs_with_const_lr == 100
    assert cfg.lr_divisor == 2.0
    assert cfg.weight_decay == 1e-7
    assert cfg.val_interval == 2
    assert tuple(cfg.pad_crop_shape) == (384, 384, 64)
    assert tuple(cfg.sliding_window_inferer_roi_size) == (384, 384, 64)
    assert cfg.model == "UNet2d5_spvPA"
    assert cfg.channels == (16, 32, 48, 64, 80, 96)
    assert cfg.num_res_units == 2 and cfg.dropout == 0.1


def test_debug_mode_overrides():
    cfg = _parse(["--debug"])
    # reference debug overrides (params/VSparams.py:74-98)
    assert cfg.split_csv == "./params/split_debug.csv"
    assert tuple(cfg.pad_crop_shape) == (128, 128, 32)
    assert cfg.num_epochs == 10
    assert cfg.epochs_with_const_lr == 3
    assert tuple(cfg.sliding_window_inferer_roi_size) == (128, 128, 32)
    assert cfg.results_folder_path.endswith("results/debug")


def test_ablation_flags():
    cfg = _parse(["--no_attention", "--no_hardness", "--dataset", "T2",
                  "--train_batch_size", "3", "--initial_learning_rate", "2e-4"])
    assert not cfg.attention and not cfg.hardness
    assert cfg.dataset == "T2"
    assert cfg.train_batch_size == 3
    assert np.isclose(cfg.initial_learning_rate, 2e-4)


def test_results_paths():
    cfg = Config(results_folder_name="run1", data_root="/x/")
    assert cfg.results_folder_path == "/x/results/run1"
    assert cfg.logs_path.endswith("run1/logs")
    assert cfg.model_path.endswith("run1/model")
    assert cfg.figures_path.endswith("run1/figures")
