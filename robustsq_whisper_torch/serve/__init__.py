from .engine import EngineConfig, TranscriptionEngine
from .server import MicroBatcher, audio_from_bytes, make_server
