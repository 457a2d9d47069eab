"""Dense video captioning, PDVC-Mamba (counterpart of the JAX package's
``tasks/captioning``): the detector with its Mamba encoder and deformable
decoder, the caption heads, the Hungarian matcher, the set criterion,
``CaptioningTrainer``, the ActivityNet-Captions data and the dense
captioning metrics (host Python)."""

from .criterion import pdvc_losses
from .data import collate_captioning, load_activitynet_captions, vocab_list
from .matcher import cl_to_se, giou_1d, host_lsa, hungarian_match, match_cost
from .metrics import (
    bleu4,
    cider_d,
    evaluate_dvc,
    evaluate_para,
    rerank_predictions,
    rouge_l,
    soda_c,
)
from .model import (
    PDVC,
    DeformableTransformer,
    DSACaptioner,
    LSTMCaptioner,
    LSTMCell,
    pdvc_level_shapes,
)
from .scorers import (
    bleu_corpus,
    cider_corpus,
    meteor_corpus,
    ptb_tokenize,
    rouge_l_corpus,
)
from .train import (
    CaptioningTrainer,
    build_captioning_trainer,
    captioning_trainer_kwargs,
)

__all__ = [
    "CaptioningTrainer", "DSACaptioner", "DeformableTransformer",
    "LSTMCaptioner", "LSTMCell", "PDVC", "bleu4", "bleu_corpus",
    "build_captioning_trainer", "captioning_trainer_kwargs", "cider_corpus",
    "cider_d", "cl_to_se", "collate_captioning", "evaluate_dvc",
    "evaluate_para", "giou_1d", "host_lsa", "hungarian_match",
    "load_activitynet_captions", "match_cost", "meteor_corpus",
    "pdvc_level_shapes", "pdvc_losses", "ptb_tokenize", "rerank_predictions",
    "rouge_l", "rouge_l_corpus", "soda_c", "vocab_list",
]
