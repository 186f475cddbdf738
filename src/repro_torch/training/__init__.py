"""repro_torch.training — train and serve step factories, and the paper's
finetuning recipes: QAT (an ABFP quant mode in the train step), DNF
(histogram capture and the noisy FLOAT train step) and the ABFP
evaluation."""

from repro_torch.training.finetune import (  # noqa: F401
    capture_histograms,
    evaluate_abfp,
    make_dnf_train_step,
)
from repro_torch.training.train_lib import (  # noqa: F401
    TrainConfig,
    TrainState,
    chunked_cross_entropy,
    cross_entropy,
    make_serve_steps,
    make_train_step,
)
