"""CLI-level parity harness: the WHOLE VS_inference.py path (staging ->
fused sliding-window loop -> Gaussian blending -> argmax -> NIFTI export)
against a torch oracle built from the REFERENCE'S OWN model source running
MONAI-0.4 sliding-window semantics on the same weights.

This closes the seam the per-module golden tests cannot see: the window
loop + converter + exporter COMPOSED (reference params/VSparams.py:552-594).
The model is the full flagship config (channels 16..96, reference
params/VSparams.py:343-374) at the debug ROI (128, 128, 32) over synthetic
(160, 160, 36) volumes -> a real 2x2x2 = 8-window blend.

Oracle independence: window starts (MONAI 0.4 `dense_patch_slices` +
`_get_scan_interval`) and the Gaussian importance map
(`compute_importance_map` / `gaussian_1d`, truncated=4.0) are re-derived
here in numpy, NOT imported from vs_seg.
"""

import itertools
import math
import os

import numpy as np
import pytest
import torch

RefUNet2d5_spvPA = None


@pytest.fixture(autouse=True, scope="module")
def _reference_classes(reference_src):
    global RefUNet2d5_spvPA
    from params.networks.nets.unet2d5_spvPA import (
        UNet2d5_spvPA as RefUNet2d5_spvPA,
    )

FLAGSHIP = dict(
    channels=(16, 32, 48, 64, 80, 96),
    strides=((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
    kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3),
                  (3, 3, 3)),
    sample_kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3),
                         (3, 3, 3)),
)
ROI = (128, 128, 32)          # debug-mode ROI (core/config.py:107)
VOLUME = (160, 160, 36)       # (H, W, D) -> 2x2x2 windows at overlap 0.25
OVERLAP = 0.25

# The reference CLI flag matrix (VSparams.py:39-66), parity-pinned
# end-to-end: --no_attention changes the model topology and --dataset the
# file naming/path scheme, so both get full CLI legs here.  --no_hardness
# only affects the TRAINING loss (VSparams.py:381-386) — its parity is
# pinned value+gradient against the reference source across all four
# (attention, hardness) combos in test_reference_oracle.py.
LEGS = {
    "att-T1": dict(attention=True, dataset="T1"),
    "noatt-T2": dict(attention=False, dataset="T2"),
}


# --- MONAI 0.4 sliding-window semantics, re-derived ------------------------

def _monai_scan_interval(image_size, roi_size, overlap):
    return tuple(
        int(r * (1 - overlap)) if r < i else r
        for i, r in zip(image_size, roi_size))


def _monai_starts(image_size, roi_size, overlap):
    """MONAI 0.4 monai.data.utils.dense_patch_slices start positions."""
    interval = _monai_scan_interval(image_size, roi_size, overlap)
    per_dim = []
    for i in range(3):
        if interval[i] == 0:
            per_dim.append([0])
            continue
        num = int(math.ceil(float(image_size[i]) / interval[i]))
        scan_dim = next(
            (d for d in range(num)
             if d * interval[i] + roi_size[i] >= image_size[i]), None)
        num = (scan_dim + 1) if scan_dim is not None else 1
        per_dim.append([min(d * interval[i], image_size[i] - roi_size[i])
                        for d in range(num)])
    return list(itertools.product(*per_dim))


def _monai_gaussian_map(roi_size, sigma_scale=0.125):
    """compute_importance_map(mode="gaussian"): unit impulse at roi//2 run
    through GaussianFilter (separable gaussian_1d, truncated=4.0), divided
    by its max, clamped to the minimum non-zero value."""
    maps_1d = []
    for n in roi_size:
        sigma = max(n * sigma_scale, 1e-5)
        tail = int(sigma * 4.0 + 0.5)
        x = np.arange(-tail, tail + 1, dtype=np.float64)
        k = np.exp(-0.5 * x * x / (sigma * sigma))
        k /= k.sum()
        center = n // 2
        resp = np.zeros(n)
        for p in range(n):
            off = p - center  # kernel is centered on the impulse
            if -tail <= off <= tail:
                resp[p] = k[off + tail]
        maps_1d.append(resp)
    m = (maps_1d[0][:, None, None] * maps_1d[1][None, :, None]
         * maps_1d[2][None, None, :])
    m = (m / m.max()).astype(np.float32)
    m = np.clip(m, m[m != 0].min(), None)
    return m


def _oracle_sliding_window(volume_hwdc, ref_model):
    """torch reference model + MONAI-0.4 blending -> (H, W, D, C_out) f32."""
    H, W, D, _ = volume_hwdc.shape
    starts = _monai_starts((H, W, D), ROI, OVERLAP)
    gauss = _monai_gaussian_map(ROI)
    x = torch.from_numpy(volume_hwdc.transpose(3, 0, 1, 2)[None])  # (1,C,H,W,D)
    out_acc = None
    w_acc = np.zeros((H, W, D, 1), np.float32)
    with torch.no_grad():
        for (h0, w0, d0) in starts:
            win = x[:, :, h0:h0 + ROI[0], w0:w0 + ROI[1], d0:d0 + ROI[2]]
            logits = ref_model(win.float())[0].numpy()[0]  # (C_out, h, w, d)
            logits = logits.transpose(1, 2, 3, 0)
            if out_acc is None:
                out_acc = np.zeros((H, W, D, logits.shape[-1]), np.float32)
            out_acc[h0:h0 + ROI[0], w0:w0 + ROI[1], d0:d0 + ROI[2]] += (
                logits * gauss[..., None])
            w_acc[h0:h0 + ROI[0], w0:w0 + ROI[1], d0:d0 + ROI[2], 0] += gauss
    return out_acc / w_acc


# --- the harness -----------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request):
    return LEGS[request.param]


@pytest.fixture(scope="module")
def ref_flagship(leg):
    torch.manual_seed(3)
    model = RefUNet2d5_spvPA(
        dimensions=3, in_channels=1, out_channels=2, num_res_units=2,
        norm="batch", dropout=0.1, attention_module=leg["attention"],
        **FLAGSHIP)
    # non-degenerate BN running stats so eval-mode normalization is real
    sd = model.state_dict()
    g = torch.Generator().manual_seed(4)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
        elif k.endswith("running_var"):
            sd[k] = 1.0 + 0.2 * torch.rand(v.shape, generator=g)
    model.load_state_dict(sd)
    model.eval()
    return model


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory, ref_flagship):
    from vs_seg.data.synthetic import generate_dataset
    root = str(tmp_path_factory.mktemp("clipar"))
    generate_dataset(root, n_train=2, n_val=2, n_test=2, shape=VOLUME, seed=5)
    model_dir = os.path.join(root, "results", "debug", "model")
    os.makedirs(model_dir, exist_ok=True)
    torch.save(ref_flagship.state_dict(),
               os.path.join(model_dir, "best_metric_model.pth"))
    return root


@pytest.fixture(scope="module")
def cli_run(dataset_root, leg):
    import importlib.util
    cli_path = os.path.join(os.path.dirname(__file__), "..", "VS_inference.py")
    spec = importlib.util.spec_from_file_location("vs_seg_cli_inference",
                                                  os.path.abspath(cli_path))
    VS_inference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(VS_inference)
    VS_inference.main([
        "--debug", "--data_root", dataset_root,
        "--results_folder_name", "ignored-in-debug",
        "--dataset", leg["dataset"],
        "--compute_dtype", "float32", "--infer_dtype", "float32",
        "--sw_batch_size", "2",
    ] + ([] if leg["attention"] else ["--no_attention"]))
    return dataset_root


def _preprocessed_test_cases(root, dataset="T1"):
    """The CLI's own test pipeline (load -> channel -> RAS -> normalize)."""
    from vs_seg.core.config import Config
    from vs_seg.data.dataset import load_split_csv
    from vs_seg.data.transforms import get_transforms
    cfg = Config(debug=True, data_root=root, dataset=dataset)
    _, _, test_files = load_split_csv(cfg.split_csv, cfg.dataset, root)
    _, _, test_t = get_transforms(cfg.pad_crop_shape_test)
    return [test_t(dict(f)) for f in test_files]


def test_cli_inference_matches_reference_sliding_window(cli_run, ref_flagship,
                                                        leg):
    """Exported labelmaps from the real VS_inference.py run must equal the
    torch oracle's argmax; blended logits from our engine-level sliding
    window must match the oracle within float32 tolerance.  Runs once per
    CLI leg (attention on/T1 and --no_attention/T2)."""
    from vs_seg.data import nifti

    root = cli_run
    cases = _preprocessed_test_cases(root, leg["dataset"])
    assert cases, "no test cases"
    for sample in cases:
        image = np.asarray(sample["image"])[0]  # (H, W, D) RAS, normalized
        meta = sample["image_meta"]
        oracle = _oracle_sliding_window(image[..., None].astype(np.float32),
                                        ref_flagship)
        oracle_labels = np.argmax(oracle, axis=-1).astype(np.float32)

        case = os.path.basename(os.path.dirname(meta["filename_or_obj"]))
        seg_name = os.path.basename(
            sample["label_meta"]["filename_or_obj"]).replace(".nii.gz", "")
        out_path = os.path.join(root, "results", "debug",
                                "inferred_segmentations_nifti", case,
                                seg_name + ".nii.gz")
        assert os.path.exists(out_path), out_path
        exported = nifti.load(out_path)
        # exported labelmap is in ORIGINAL orientation; bring back to RAS
        ras, _, _ = nifti.reorient_to(
            np.asarray(exported.data, np.float32), exported.affine)
        assert ras.shape == oracle_labels.shape
        mismatch = float(np.mean(ras != oracle_labels))
        assert mismatch == 0.0, f"{case}: {mismatch:.2e} voxels differ"


def test_full_size_pth_strict_roundtrip(ref_flagship, leg, tmp_path):
    """The Zenodo seam, hardened to a data-only problem (VERDICT r3 task 8):
    a FULL-SIZE flagship `.pth` with the exact Zenodo state-dict naming
    (saved by torch from the reference's own model class, the same way
    params/VSparams.py:508,526 writes best_metric_model.pth) must round-trip
    through compat/torch_import with STRICT key accounting — every checkpoint
    tensor consumed, every expected tensor present. This test passes
    unchanged on the real Zenodo checkpoints (README.md:161-170): point it at
    one via `VS_ZENODO_PTH=/path/to/best_metric_model.pth`."""
    from vs_seg.compat.torch_import import import_unet2d5_spvpa, load_pth

    pth = os.environ.get("VS_ZENODO_PTH")
    if pth is None:
        pth = str(tmp_path / "best_metric_model.pth")
        torch.save(ref_flagship.state_dict(), pth)
    sd = load_pth(pth)
    # exactly the torch tensor set the reference architecture produces
    expected_keys = set(RefUNet2d5_spvPA(
        dimensions=3, in_channels=1, out_channels=2, num_res_units=2,
        norm="batch", dropout=0.1, attention_module=leg["attention"],
        **FLAGSHIP).state_dict().keys())
    assert set(sd.keys()) == expected_keys

    params, stats = import_unet2d5_spvpa(
        sd, attention=leg["attention"])  # strict=True default
    # spot-check full-size flagship shapes (Zenodo checkpoints are this size)
    assert params["down_0"]["unit0"]["conv"]["kernel"].shape == (3, 3, 1, 1, 16)
    assert params["bottom"]["unit0"]["conv"]["kernel"].shape == (3, 3, 3, 80, 96)
    assert stats["down_0"]["unit0"]["norm"]["mean"].shape == (16,)

    # strictness: an extra tensor is rejected, a missing one is named
    # (down_0's first conv exists — and is consumed first — on both legs)
    sd_extra = dict(sd)
    sd_extra["model.0.conv.unit0.conv.weight_v"] = sd["model.0.conv.unit0.conv.weight"]
    with pytest.raises(ValueError, match="unexpected key"):
        import_unet2d5_spvpa(sd_extra, attention=leg["attention"])
    sd_missing = {k: v for k, v in sd.items()
                  if k != "model.0.conv.unit0.conv.weight"}
    with pytest.raises(KeyError, match="model.0.conv.unit0.conv.weight"):
        import_unet2d5_spvpa(sd_missing, attention=leg["attention"])


def test_engine_blended_logits_match_oracle(dataset_root, ref_flagship, leg):
    """Direct logit-level bound: our fused window loop + XLA blending
    vs the oracle accumulation, same weights, float32."""
    import jax.numpy as jnp

    from vs_seg.compat.torch_import import import_unet2d5_spvpa
    from vs_seg.infer.engine import make_predictor
    from vs_seg.infer.sliding_window import sliding_window_inference
    from vs_seg.models import UNet2d5_spvPA

    sample = _preprocessed_test_cases(dataset_root, leg["dataset"])[0]
    image = np.asarray(sample["image"])[0].astype(np.float32)

    params, stats = import_unet2d5_spvpa(
        {k: v.clone() for k, v in ref_flagship.state_dict().items()},
        channels=FLAGSHIP["channels"], num_res_units=2,
        attention=leg["attention"])
    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=0.1,
                          attention_module=leg["attention"],
                          dtype=jnp.float32)
    predictor = make_predictor(model, params, stats, dtype=jnp.float32)

    ours = np.asarray(sliding_window_inference(
        image[..., None], ROI, predictor, overlap=OVERLAP, sw_batch_size=2,
        mode="gaussian", bucket=(64, 64, 16), predictor_layout="dfirst"))
    oracle = _oracle_sliding_window(image[..., None], ref_flagship)
    assert ours.shape == oracle.shape
    np.testing.assert_allclose(ours, oracle, atol=2e-3, rtol=1e-3)
