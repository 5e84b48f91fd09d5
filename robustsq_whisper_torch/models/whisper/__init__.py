from .config import WhisperDims, sinusoids, whisper_dims

__all__ = ["WhisperDims", "sinusoids", "whisper_dims"]
