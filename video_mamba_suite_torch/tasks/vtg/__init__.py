"""Video temporal grounding and highlight detection: UniVTG-Mamba, its
losses, targets, metrics and trainers for moment retrieval, highlight
detection, VLP pretraining and query-focused summarization (counterpart
of the JAX package's ``tasks/vtg``), and grounding on a raw video
(``run_on_video``)."""

from .data import (
    build_targets,
    collate_vtg,
    load_file_dataset,
    load_jsonl_dataset,
    make_synthetic_vtg,
)
from .dataset import VtgDataset
from .hl import (
    TVSUM_SPLITS,
    HlTrainer,
    build_hl_trainer,
    collate_hl,
    hl_losses,
    tvsum_map_at_k,
)
from .losses import generalized_temporal_iou, smooth_l1, vtg_losses
from .metrics import compute_hl_ap, compute_hl_hit1, compute_mr_ap, compute_mr_r1
from .model import ConvHead, LinearLayer, UniVTGMamba, WeightedPool
from .run_on_video import VtgFeatureExtractor, ground_video
from .qfvs import (
    QfvsTrainer,
    calculate_semantic_matching,
    collate_qfvs,
    make_synthetic_qfvs,
    qfvs_losses,
    semantic_iou,
)
from .train import (
    UniVtgTrainer,
    VtgTrainer,
    build_vtg_trainer,
    vtg_trainer_kwargs,
)
from .vlp import VlpPretrainer, build_vlp_sample, make_synthetic_vlp

__all__ = [
    "ConvHead", "HlTrainer", "LinearLayer", "QfvsTrainer", "TVSUM_SPLITS",
    "UniVTGMamba", "UniVtgTrainer", "VlpPretrainer", "VtgDataset",
    "VtgFeatureExtractor", "VtgTrainer", "WeightedPool", "build_hl_trainer", "build_targets",
    "build_vlp_sample", "build_vtg_trainer",
    "calculate_semantic_matching", "collate_hl", "collate_qfvs",
    "collate_vtg", "compute_hl_ap", "compute_hl_hit1", "compute_mr_ap",
    "compute_mr_r1", "generalized_temporal_iou", "ground_video",
    "hl_losses",
    "load_file_dataset", "load_jsonl_dataset", "make_synthetic_qfvs",
    "make_synthetic_vlp", "make_synthetic_vtg", "qfvs_losses",
    "semantic_iou", "smooth_l1", "tvsum_map_at_k", "vtg_losses",
    "vtg_trainer_kwargs",
]
