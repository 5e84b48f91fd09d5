from .qformer import QFormerAdapter, QformerConfig
from .ts_decoder import STARTOFPREV, TSDecoder
from .speaker_resnet import SpeakerResNet34
from .ts_encoder import QFormerTSEncoder, SpkAdapterTSEncoder, TSEncoderConfig
from .ts_model import TSASRModel, TSModelConfig
from .whisper.config import WhisperDims, whisper_dims
from .whisper.modules import AudioEncoder, TextDecoder

__all__ = [
    "AudioEncoder", "QFormerAdapter", "QFormerTSEncoder", "QformerConfig",
    "STARTOFPREV", "SpeakerResNet34", "SpkAdapterTSEncoder", "TSASRModel", "TSDecoder",
    "TSEncoderConfig", "TSModelConfig", "TextDecoder", "WhisperDims", "whisper_dims",
]
