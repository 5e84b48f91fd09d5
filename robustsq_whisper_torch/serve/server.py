"""Micro-batching HTTP transcription daemon (standard-library HTTP).

The port's copy of the JAX package's ``serve/server.py``. HTTP handler
threads submit (speech, enroll) pairs to the ``MicroBatcher`` and block on
a Future; a stager thread waits ``max_wait_ms`` after the first request
for the batch to fill and stages it (``engine.stage``: host pack, the
copy to the device, log-mel), a runner thread encodes and decodes the
staged batches (``engine.infer_staged``). Latency under load is one device
batch; an idle server adds at most ``max_wait_ms``.

API (JSON over POST):

  POST /v1/transcribe
    {"speech_wav": <base64 WAV/FLAC bytes>, "enroll_wav": <...>}
    or raw PCM: {"speech_pcm": [floats @16k], "enroll_pcm": [...]}
    -> {"text": "...", "latency_ms": 12.3}
  GET /healthz -> {"status": "ok", ...}
  GET /stats   -> request/batch/latency counters
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import queue
import tempfile
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple

import numpy as np

from .engine import TranscriptionEngine

logger = logging.getLogger("robustsq_whisper_torch.serve")


def audio_from_bytes(data: bytes, expect_rate: int = 16000) -> np.ndarray:
    """Decode WAV or FLAC bytes to float32 [-1, 1] at ``expect_rate``. WAV
    is read in memory (scipy reads file-likes); FLAC goes through the
    native decoder, which reads files, by way of a temporary file."""
    from ..data.kaldi_io import pcm_to_float, read_wav

    if data[:4] == b"fLaC":
        with tempfile.NamedTemporaryFile(suffix=".flac", delete=False) as f:
            f.write(data)
        try:
            audio, sr = read_wav(f.name)
        finally:
            os.unlink(f.name)
    else:
        from scipy.io import wavfile

        sr, raw = wavfile.read(io.BytesIO(data))
        audio = pcm_to_float(raw)
    if sr != expect_rate:
        raise ValueError(f"expected {expect_rate} Hz audio, got {sr}")
    return audio


class MicroBatcher:
    """Coalesce concurrent requests into full engine batches.

    Two-stage pipeline: a STAGER thread collects each batch and runs
    ``engine.stage`` (host pack + host->device transfer + mel dispatch —
    none of it blocks on the device), a RUNNER thread drains the staged
    queue through ``engine.infer_staged`` (encode + decode on the device).
    Batch N+1's staging therefore overlaps batch N's device compute —
    under saturated load the device never idles on the wire (the dominant
    per-batch host cost)."""

    def __init__(
        self,
        engine: TranscriptionEngine,
        max_wait_ms: float = 15.0,
        max_queue: int = 0,
    ) -> None:
        self.engine = engine
        self.max_wait = max_wait_ms / 1000.0
        # bounded admission queue: when full, submit() raises queue.Full and
        # the HTTP layer sheds with 503 instead of letting latency (and
        # handler-thread count) grow without bound. Default bound = 4 device
        # batches of headroom beyond the one staging and the one computing.
        if max_queue <= 0:
            max_queue = 4 * engine.cfg.batch_size
        self.max_queue = max_queue
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue + 1)  # +1: the
        # close() sentinel must never block behind a full admission queue;
        # submit() enforces the max_queue bound itself (under _adm_lock) so a
        # normal request can never occupy the reserved sentinel slot
        self._adm_lock = threading.Lock()
        # staged queue (maxsize=1): bounds in-flight work to the batch the
        # device is computing + one fully staged batch + (briefly) one more
        # the stager has built and is blocked put()-ing — at most two staged
        # batches exist behind the computing one in the worst case.
        self._staged: "queue.Queue" = queue.Queue(maxsize=1)
        self._closed = False
        # stats — ``requests`` counts requests RESOLVED (result or error),
        # ``batches`` counts device batches run, ``busy_s`` is device-compute
        # wall time only (staging/host work overlaps it by design)
        self.requests = 0
        self.batches = 0
        self.errors = 0
        self.shed = 0
        self.busy_s = 0.0
        self._stager = threading.Thread(target=self._stage_loop, daemon=True)
        self._runner = threading.Thread(target=self._run_loop, daemon=True)
        self._stager.start()
        self._runner.start()

    def submit(self, speech: np.ndarray, enroll: np.ndarray) -> Future:
        """Enqueue one request; raises ``queue.Full`` when the admission
        queue is at capacity (the HTTP layer turns that into 503)."""
        fut: Future = Future()
        # checks+put are atomic under the lock (the stager only ever REMOVES
        # items concurrently, so qsize can't grow past the check): exactly
        # max_queue requests can be queued, the sentinel slot stays free, and
        # — because close() flips _closed under the same lock BEFORE draining
        # — no request can slip into the queue after the shutdown drain and
        # strand its future until the result timeout
        with self._adm_lock:
            if self._closed:
                raise RuntimeError("server closing")
            if self._q.qsize() >= self.max_queue:
                self.shed += 1
                raise queue.Full
            self._q.put_nowait((speech, enroll, fut))
        return fut

    def _mark_closed(self) -> None:
        with self._adm_lock:
            self._closed = True

    def close(self) -> None:
        self._mark_closed()  # under _adm_lock: no submit() can race past it
        self._q.put(None)  # wake the stager; it forwards the stop downstream
        self._stager.join(timeout=5)
        self._runner.join(timeout=5)
        self._fail_pending(RuntimeError("server closing"))

    def _fail_pending(self, exc: Exception) -> None:
        """Drain the admission queue and fail every stranded future — without
        this, requests submitted around shutdown would block their HTTP
        handlers until the result timeout."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            _, _, fut = item
            self.errors += 1
            self.requests += 1
            if not fut.done():
                fut.set_exception(exc)

    def _stage_loop(self) -> None:
        bs = self.engine.cfg.batch_size
        while not self._closed:
            first = self._q.get()
            if first is None:
                break
            batch = [first]
            deadline = time.time() + self.max_wait
            while len(batch) < bs:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    self._closed = True
                    break
                batch.append(item)
            futs = [fut for _, _, fut in batch]
            try:
                staged = self.engine.stage([(s, e) for s, e, _ in batch])
            except Exception as exc:  # bad audio shapes etc: fail this batch
                self.errors += len(batch)
                self.requests += len(batch)
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            self._staged.put((staged, futs))
        # on exit (close() raced a blocking _staged.put, or a None arrived
        # mid-fill): strand nothing — fail whatever is still queued
        self._fail_pending(RuntimeError("server closing"))
        self._staged.put(None)  # stop the runner

    def _run_loop(self) -> None:
        while True:
            entry = self._staged.get()
            if entry is None:
                break
            staged, futs = entry
            t0 = time.time()
            try:
                texts = self.engine.infer_staged(staged, len(futs))
                err = None
            except Exception as exc:  # surface to every waiting caller
                texts, err = None, exc
                self.errors += len(futs)
            # counters update BEFORE futures resolve: a caller observing its
            # result must see the stats that include its own request
            self.busy_s += time.time() - t0
            self.requests += len(futs)
            self.batches += 1
            if err is None:
                for fut, text in zip(futs, texts):
                    fut.set_result(text)
            else:
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(err)


def _parse_audio(body: dict, key: str, sample_rate: int) -> np.ndarray:
    if f"{key}_wav" in body:
        return audio_from_bytes(
            base64.b64decode(body[f"{key}_wav"]), sample_rate
        )
    if f"{key}_pcm" in body:
        return np.asarray(body[f"{key}_pcm"], np.float32)
    raise ValueError(f"missing {key}_wav or {key}_pcm")


def make_server(
    engine: TranscriptionEngine,
    host: str = "0.0.0.0",
    port: int = 8080,
    max_wait_ms: float = 15.0,
    info: Optional[dict] = None,
    max_queue: int = 0,
    max_body_bytes: int = 64 * 1024 * 1024,
    result_timeout_s: float = 120.0,
) -> Tuple[ThreadingHTTPServer, MicroBatcher]:
    """Build (but do not start) the HTTP server; call ``serve_forever()``
    on the returned server and ``close()`` on the batcher at shutdown.
    ``port=0`` binds an ephemeral port (``server.server_address[1]``).

    Overload behavior: bodies over ``max_body_bytes`` get 413 without being
    read; a full admission queue (``max_queue``, default 4 device batches)
    gets 503 + Retry-After; a request older than ``result_timeout_s`` gets
    504. All three bound worst-case handler-thread lifetime and memory."""
    batcher = MicroBatcher(engine, max_wait_ms, max_queue=max_queue)
    sample_rate = engine.cfg.sample_rate
    static_info = {
        "batch_size": engine.cfg.batch_size,
        "speech_seconds": engine.cfg.speech_seconds,
        "enroll_seconds": engine.cfg.enroll_seconds,
        "sample_rate": sample_rate,
        **(info or {}),
    }

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: Any) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, fmt, *args):  # route through logging, not stderr
            logger.debug("%s - %s", self.address_string(), fmt % args)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(
                    200,
                    {
                        "status": "ok",
                        "compiled": engine.compiled,
                        **static_info,
                    },
                )
            elif self.path == "/stats":
                self._json(
                    200,
                    {
                        # requests = resolved (result or error); batches =
                        # device batches run; busy_seconds = device-compute
                        # wall only (staging/host work overlaps it); shed =
                        # 503s from a full admission queue
                        "requests": batcher.requests,
                        "batches": batcher.batches,
                        "errors": batcher.errors,
                        "shed": batcher.shed,
                        "queue_depth": batcher._q.qsize(),
                        "busy_seconds": round(batcher.busy_s, 3),
                        "mean_batch_fill": round(
                            batcher.requests / max(batcher.batches, 1), 3
                        ),
                    },
                )
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/transcribe":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return
            if length > max_body_bytes:
                # refuse before reading: an oversized body never buffers
                self._json(
                    413,
                    {"error": f"body {length} > limit {max_body_bytes} bytes"},
                )
                return
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                speech = _parse_audio(body, "speech", sample_rate)
                enroll = _parse_audio(body, "enroll", sample_rate)
            except Exception as exc:
                self._json(400, {"error": str(exc)})
                return
            t0 = time.time()
            try:
                fut = batcher.submit(speech, enroll)
            except queue.Full:
                self.send_response(503)
                payload = json.dumps(
                    {"error": "server overloaded, retry later"}
                ).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(payload)
                return
            except RuntimeError as exc:  # closing
                self._json(503, {"error": str(exc)})
                return
            try:
                text = fut.result(timeout=result_timeout_s)
            # concurrent.futures.TimeoutError is only a builtin-TimeoutError
            # subclass from Python 3.11; catch both so 3.10 still gets a 504
            except (TimeoutError, FuturesTimeout):
                self._json(
                    504,
                    {"error": f"no result within {result_timeout_s:.0f}s"},
                )
                return
            except Exception as exc:
                self._json(500, {"error": str(exc)})
                return
            self._json(
                200,
                {"text": text, "latency_ms": round((time.time() - t0) * 1e3, 2)},
            )

    # The stdlib default listen backlog (5) drops simultaneous connects as
    # soon as a few dozen clients arrive together; size it to the largest
    # burst one device batch can absorb.
    ThreadingHTTPServer.request_queue_size = 256
    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server, batcher
