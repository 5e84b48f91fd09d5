from .asr import CTCHead, add_sos_eos, label_smoothing_loss, token_accuracy
from .speaker import (
    AAMSoftmaxHead,
    AttentiveStatisticsPooling,
    aam_margin_schedule,
    arc_infonce_loss,
    asp_gamma_schedule,
    sample_negatives,
)

__all__ = [
    "AAMSoftmaxHead", "AttentiveStatisticsPooling", "CTCHead",
    "aam_margin_schedule", "add_sos_eos", "arc_infonce_loss",
    "asp_gamma_schedule", "label_smoothing_loss", "sample_negatives",
    "token_accuracy",
]
