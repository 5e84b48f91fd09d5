from .engine import EngineConfig, TranscriptionEngine
