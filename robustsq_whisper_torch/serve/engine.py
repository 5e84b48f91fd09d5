"""Batched online transcription engine.

Mirrors the JAX package's ``serve/engine.py``: one (encode, run) program
pair from ``build_decode_fns``, driven at a fixed batch size. Short
requests are zero-padded into the static window; unused batch rows repeat
row 0 and are dropped on the host. Audio is staged as the decode jobs stage
it, through ``audio/frontend.py::pcm16_log_mel``: copied to the device
through pinned memory and quantized to int16's grid there (exact for
WAV/FLAC-sourced audio). A DecodeConfig with ``speculative_gamma > 0``
serves by speculative greedy decode, self-drafting or with a separate
``draft`` decoder (the JAX engine's ``draft_vars``): a distilled one
(``train/distill.py``, ``cli.serve --draft_path``) or a converted JAX
draft. It serves audio enrollment (the Qformer encoder), as the JAX engine
does; embedding enrollment decodes through ``cli.decode``.

On a ``mesh`` (``parallel/mesh.py``; one process per GPU) the engine of
rank 0 takes the requests; before it runs a staged batch it broadcasts it
(its shapes, then its tensors) to the other ranks, whose engines wait in
``follow`` and run the same batch with it: each rank encodes and decodes
its rows (or its heads, tensor-parallel) and every rank gets the whole
batch's tokens. ``close`` on rank 0 sends the followers a stop. The
followers wait for the next batch on a gloo group of their own with no
practical deadline (``IDLE_TIMEOUT``), so a server may stay idle for as
long as traffic leaves it; the batch's tensors and the decode's
collectives keep the process group's timeout.
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..audio.frontend import pcm16_log_mel
from ..decode.pipeline import build_decode_fns
from ..decode.search import DecodeConfig, strip_eot
from ..models.ts_encoder import QFormerTSEncoder
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size, world_size

# how long a follower waits for rank 0's next batch
IDLE_TIMEOUT = datetime.timedelta(days=365)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_size: int = 8
    speech_seconds: float = 30.0
    enroll_seconds: float = 10.0
    sample_rate: int = 16000
    enc_chunk: int = 0  # encoder sub-batching (chunked_encode); 0 = off


class TranscriptionEngine:
    """Thread-safe transcription of (speech, enrollment) pairs.
    ``transcribe`` accepts 1..batch_size items; the device always runs the
    full static batch."""

    def __init__(
        self,
        encoder: Any,
        decoder: Any,
        tokenizer: Any,
        dcfg: DecodeConfig,
        cfg: EngineConfig = EngineConfig(),
        mesh: Optional[Any] = None,
        draft: Optional[Any] = None,
        device="cuda",
    ) -> None:
        if not isinstance(encoder, QFormerTSEncoder):
            raise ValueError("the engine serves (speech, enrollment audio) pairs through the "
                             "Qformer encoder; embedding enrollment decodes with cli.decode")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dcfg = dcfg
        self.tokenizer = tokenizer
        self.n_mels = encoder.dims.n_mels
        sharded = axis_size(mesh, DATA_AXIS) * axis_size(mesh, MODEL_AXIS) > 1
        if sharded and cfg.batch_size % axis_size(mesh, DATA_AXIS):
            raise ValueError(f"batch_size {cfg.batch_size} must be a multiple of the "
                             f"data-axis size ({axis_size(mesh, DATA_AXIS)})")
        self.encode, self.run = build_decode_fns(
            encoder, decoder, dcfg, mesh, device=self.device, draft=draft,
            enc_chunk=cfg.enc_chunk,
        )
        self.followers = world_size() > 1 and mesh is not None
        if self.followers:  # every rank builds its engine: a collective call
            import torch.distributed as dist

            self._heads = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
        # compute callers are serialized; staging has its own lock so the
        # next batch can stage while the device runs the current one
        self._lock = threading.Lock()
        self._stage_lock = threading.Lock()
        # True once a batch has run: the kernels are built at first use
        self.compiled = False

    # ---- audio shaping ----

    def _fit(self, audio: np.ndarray, seconds: float) -> Tuple[np.ndarray, int]:
        """Zero-pad/crop to the static window; returns (row, true_len)."""
        n = int(round(seconds * self.cfg.sample_rate))
        row = np.zeros((n,), np.float32)
        ln = min(len(audio), n)
        row[:ln] = audio[:ln]
        return row, ln

    def _pack(self, items: Sequence[Tuple[np.ndarray, np.ndarray]]):
        b = self.cfg.batch_size
        if not 1 <= len(items) <= b:
            raise ValueError(f"1..{b} items required, got {len(items)}")
        s_len = int(round(self.cfg.speech_seconds * self.cfg.sample_rate))
        e_len = int(round(self.cfg.enroll_seconds * self.cfg.sample_rate))
        speech = np.zeros((b, s_len), np.float32)
        enroll = np.zeros((b, e_len), np.float32)
        slens = np.zeros((b,), np.int32)
        elens = np.zeros((b,), np.int32)
        for i, (sp, en) in enumerate(items):
            speech[i], slens[i] = self._fit(sp, self.cfg.speech_seconds)
            enroll[i], elens[i] = self._fit(en, self.cfg.enroll_seconds)
        for i in range(len(items), b):  # pad rows repeat row 0
            speech[i], slens[i] = speech[0], slens[0]
            enroll[i], elens[i] = enroll[0], elens[0]
        return speech, slens, enroll, elens

    # ---- inference ----

    def stage(self, items: Sequence[Tuple[np.ndarray, np.ndarray]]):
        """Host pack, then ``pcm16_log_mel`` of the speech and of the
        enrollments. Returns device-resident (feats, flens, efeats,
        eflens)."""
        speech, slens, enroll, elens = self._pack(items)
        with self._stage_lock, torch.inference_mode():
            feats, flens = pcm16_log_mel(speech, slens, self.n_mels, self.device)
            efeats, eflens = pcm16_log_mel(enroll, elens, self.n_mels, self.device)
        return feats, flens, efeats, eflens

    def infer_staged(self, staged: Tuple, n_items: int) -> List[str]:
        """Encode + decode a ``stage()`` result and detokenize the first
        ``n_items`` rows."""
        with self._lock:
            if self.followers:
                self._broadcast(staged)
            tokens = self._infer(staged).cpu().numpy()
            self.compiled = True
        rows = strip_eot(tokens[:n_items], self.dcfg.eot)
        return [self.tokenizer.decode(r).strip() for r in rows]

    def _infer(self, staged: Tuple) -> torch.Tensor:
        with torch.inference_mode():
            return self.run(*self.encode(*staged))[0]

    # ---- the other ranks of a mesh ----

    def _broadcast(self, staged: Optional[Tuple]) -> None:
        """Rank 0: the next batch's shapes and dtypes (None: stop), then its
        tensors, to every rank."""
        import torch.distributed as dist

        head = [None if staged is None else [(tuple(t.shape), t.dtype) for t in staged]]
        dist.broadcast_object_list(head, src=0, group=self._heads)
        with torch.inference_mode():
            for t in staged or ():
                dist.broadcast(t.contiguous(), src=0)

    def follow(self) -> None:
        """A rank other than 0: run each batch rank 0 broadcasts until it
        sends the stop. Without a mesh (``--data_parallel false``, or a
        draft) rank 0 serves alone and this returns at once."""
        import torch.distributed as dist

        while self.followers:
            head = [None]
            dist.broadcast_object_list(head, src=0, group=self._heads)
            if head[0] is None:
                return
            with torch.inference_mode():
                staged = tuple(torch.empty(shape, dtype=dtype, device=self.device)
                               for shape, dtype in head[0])
                for t in staged:
                    dist.broadcast(t, src=0)
            self._infer(staged)

    def close(self) -> None:
        """Rank 0: stop the followers (a no-op without them)."""
        if self.followers:
            with self._lock:
                self._broadcast(None)
                self.followers = False

    def transcribe(
        self, items: Sequence[Tuple[np.ndarray, np.ndarray]]
    ) -> List[str]:
        """items: (speech f32 in [-1, 1] at 16 kHz, enrollment likewise)
        pairs. Returns one transcript per item."""
        return self.infer_staged(self.stage(items), len(items))

    def warmup(self) -> float:
        """Run the full pipeline once on silence; returns wall seconds."""
        n = int(self.cfg.sample_rate)
        t0 = time.time()
        self.transcribe([(np.zeros(n, np.float32), np.zeros(n, np.float32))])
        return time.time() - t0
