"""Microphone capture sources feeding the native SPSC ring, port of the
JAX package's ``runtime/capture.py``.

The reference captures audio two ways: Godot's ``AudioEffectCapture``
pulled from a dedicated GDScript thread
(godot-whisper bin/addons/godot_whisper/capture_stream_to_text.gd:69-75)
and SDL capture devices for the standalone CLIs (whisper.cpp
examples/common-sdl.cpp).  Both are the same shape: an audio-thread
producer writing into a ring, a scheduler thread draining it.

Here the boundary is the port's native single-producer single-consumer
ring (``native/audio_frontend.cpp``, built by ``native/bindings.py``),
which drops on overflow as AudioEffectCapture does when unread; without a
C++ compiler a pure-Python ring (``_PyRing``) with the same contract takes
its place.  The producer is one of:

- ``sounddevice``: a PortAudio input stream (optional dependency; the audio
  callback pushes straight into the ring);
- ``arecord``: an ALSA capture subprocess streaming raw f32 PCM;
- ``synthetic``: a paced producer thread generating a deterministic
  waveform in real time (tests, machines without audio hardware).

``CaptureSource`` is what ``cli.stream --mic`` drains each transcribe
interval, the reference's get_buffer(frames_available) pull
(capture_stream_to_text.gd:73-75).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from ..models.config import SAMPLE_RATE


class _PyRing:
    """Fallback pure-Python ring with the same drop-on-overflow
    contract as the native SPSC ring (used when the native library is
    unavailable; a lock stands in for the atomics)."""

    def __init__(self, capacity: int):
        self._buf = np.zeros(capacity, np.float32)
        self._cap = capacity
        self._head = 0
        self._tail = 0
        self._lock = threading.Lock()

    def push(self, data: np.ndarray) -> int:
        data = np.asarray(data, np.float32)
        with self._lock:
            free = self._cap - (self._head - self._tail)
            n = min(len(data), free)
            for off in range(n):   # capacity is small; clarity over speed
                self._buf[(self._head + off) % self._cap] = data[off]
            self._head += n
            return n

    def pop(self, n: int) -> np.ndarray:
        with self._lock:
            avail = self._head - self._tail
            n = min(n, avail)
            out = np.empty(n, np.float32)
            for off in range(n):
                out[off] = self._buf[(self._tail + off) % self._cap]
            self._tail += n
            return out

    @property
    def available(self) -> int:
        with self._lock:
            return self._head - self._tail


def _make_ring(capacity: int):
    from ..native.bindings import NativeRing, available
    return NativeRing(capacity) if available() else _PyRing(capacity)


class CaptureSource:
    """A microphone (or synthetic) audio source drained via a ring.

    Usage::

        src = CaptureSource(backend="auto")
        src.start()
        while ...:
            frames = src.read_available()   # f32 @ source rate
            transcriber.push_audio(frames)
        src.stop()
    """

    def __init__(self, backend: str = "auto", *, device=None,
                 rate: int = SAMPLE_RATE, ring_seconds: float = 30.0,
                 synthetic_wave: Optional[Callable[[np.ndarray],
                                                   np.ndarray]] = None):
        self.backend = backend
        self.device = device
        self.rate = rate
        self.ring = _make_ring(int(ring_seconds * rate))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None
        self._proc = None
        self._synthetic_wave = synthetic_wave or self._default_wave
        self.dropped = 0   # samples lost to ring overflow

    # ------------------------------------------------------------ lifecycle
    def start(self) -> str:
        """Start the producer; returns the backend actually used."""
        order = ([self.backend] if self.backend != "auto"
                 else ["sounddevice", "arecord"])
        last_err = None
        for b in order:
            try:
                getattr(self, f"_start_{b}")()
                self.backend = b
                return b
            except Exception as e:  # try the next backend
                last_err = e
        raise RuntimeError(
            f"no capture backend available (tried {order}): {last_err}")

    def stop(self) -> None:
        self._stop.set()
        if self._stream is not None:
            try:
                self._stream.stop()
                self._stream.close()
            except Exception:
                pass
            self._stream = None
        if self._proc is not None:
            try:
                self._proc.terminate()
                self._proc.wait(timeout=2)
            except Exception:
                pass
            self._proc = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # ------------------------------------------------------------- drain
    def read_available(self, max_samples: Optional[int] = None) -> np.ndarray:
        """Pull everything buffered (the AudioEffectCapture
        get_buffer(frames_available) pattern)."""
        n = self.ring.available
        if max_samples is not None:
            n = min(n, max_samples)
        return self.ring.pop(n)

    def _push(self, frames: np.ndarray) -> None:
        wrote = self.ring.push(frames)
        self.dropped += len(frames) - wrote

    # ----------------------------------------------------------- backends
    def _start_sounddevice(self) -> None:
        import sounddevice as sd  # optional dependency

        def cb(indata, n_frames, time_info, status):
            # PortAudio audio thread = the single producer
            self._push(indata[:, 0] if indata.ndim > 1 else indata)

        self._stream = sd.InputStream(
            samplerate=self.rate, channels=1, dtype="float32",
            device=self.device, callback=cb)
        self._stream.start()

    def _start_arecord(self) -> None:
        import shutil
        import subprocess
        if shutil.which("arecord") is None:
            raise RuntimeError("arecord not found")
        cmd = ["arecord", "-q", "-f", "FLOAT_LE", "-r", str(self.rate),
               "-c", "1", "-t", "raw"]
        if self.device:
            cmd += ["-D", str(self.device)]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)

        def reader():
            chunk = self.rate // 10 * 4     # 100 ms of f32
            while not self._stop.is_set():
                data = self._proc.stdout.read(chunk)
                if not data:
                    break
                self._push(np.frombuffer(data, np.float32))

        self._thread = threading.Thread(target=reader, daemon=True,
                                        name="gwt-arecord")
        self._thread.start()

    @staticmethod
    def _default_wave(t: np.ndarray) -> np.ndarray:
        return (0.2 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)

    def _start_synthetic(self) -> None:
        def producer():
            i = 0
            step = self.rate // 20          # 50 ms blocks
            period = step / self.rate
            next_t = time.perf_counter()
            while not self._stop.is_set():
                t = (i + np.arange(step)) / self.rate
                self._push(self._synthetic_wave(t))
                i += step
                next_t += period
                delay = next_t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)

        self._thread = threading.Thread(target=producer, daemon=True,
                                        name="gwt-synthetic-mic")
        self._thread.start()
