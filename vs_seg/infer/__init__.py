from vs_seg.infer.sliding_window import sliding_window_inference, gaussian_importance_map
from vs_seg.infer.engine import run_inference, make_predictor
