"""video_mamba_suite_torch: the PyTorch / CUDA port of the video Mamba
suite, for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
becomes a kernel written by hand for sm_90a under ``csrc/``, built with
nvcc on first use. This package imports neither JAX nor the JAX package.
Entry points build on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .models import (
    CLIP,
    GenerationConfig,
    MambaDBM,
    MambaHarnessLM,
    MambaLMHeadModel,
    MambaVim,
    TimeMamba,
    ViViM,
    build_mamba_lm,
    build_timemamba_b,
    build_vivim_tiny_k400,
    from_pretrained,
    generate,
    perplexity,
    quantize_lm_for_decode,
    sequence_loglikelihood,
)
from .tasks.anticipation import (
    AnticipationTrainer,
    LSTRMamba,
    build_anticipation_trainer,
)
from .tasks.egocentric import (
    ClipPretrainer,
    ClsFinetuner,
    MirFinetuner,
    VideoClassifier,
    build_clip_mir,
    build_clip_pretrainer,
    build_ek100_cls,
)
from .tasks.captioning import (
    PDVC,
    CaptioningTrainer,
    build_captioning_trainer,
)
from .tasks.tal import ActionMambaDetector, TalTrainer, build_tal_trainer
from .tasks.tas import MaTransformer, TasTrainer, build_tas_trainer
from .tasks.vtg import (
    HlTrainer,
    QfvsTrainer,
    UniVTGMamba,
    VlpPretrainer,
    VtgTrainer,
    build_hl_trainer,
    build_vtg_trainer,
)
from .tasks.recognition import (
    RecognitionTrainer,
    build_vivim_k400_trainer,
    evaluate,
    predict,
)
from .train import train_step
from .utils import make_optimizer

__all__ = ["ActionMambaDetector", "AnticipationTrainer", "CLIP",
           "CaptioningTrainer", "ClipPretrainer", "ClsFinetuner",
           "GenerationConfig", "HlTrainer", "LSTRMamba", "MaTransformer",
           "MambaDBM", "MambaHarnessLM", "MambaLMHeadModel", "MambaVim",
           "MirFinetuner", "PDVC", "QfvsTrainer", "RecognitionTrainer",
           "TalTrainer", "TasTrainer", "TimeMamba", "UniVTGMamba",
           "VideoClassifier", "ViViM", "VlpPretrainer", "VtgTrainer",
           "build_anticipation_trainer", "build_captioning_trainer",
           "build_clip_mir", "build_clip_pretrainer", "build_ek100_cls",
           "build_hl_trainer", "build_mamba_lm", "build_tal_trainer",
           "build_tas_trainer", "build_timemamba_b", "build_vtg_trainer",
           "build_vivim_k400_trainer", "build_vivim_tiny_k400", "evaluate",
           "from_pretrained", "generate", "make_optimizer", "perplexity",
           "predict", "quantize_lm_for_decode", "sequence_loglikelihood",
           "train_step"]
