"""repro_torch.training — the evaluation side of the paper's finetuning
recipes: ABFP next-token accuracy and DNF's histogram capture."""

from repro_torch.training.finetune import (  # noqa: F401
    capture_histograms,
    evaluate_abfp,
)
