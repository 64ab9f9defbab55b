"""Log-mel spectrogram frontend.

Behavioral contract (the JAX package's ``audio/mel.py``, which mirrors
``log_mel_spectrogram`` of whisper.cpp:2793-2887):

- reflective pad of N_FFT/2 = 200 samples at the front (samples[1..200]
  reversed), then 30 s of zeros + 400 at the end;
- periodic Hann window;
- per 10 ms frame: |FFT|^2 over bins 0..200, dot with the mel filterbank,
  log10 with a 1e-10 floor (kernel K1, ops/mel_kernel.py);
- the clip-global ``max - 8`` clamp and ``(x + 4) / 4`` normalization;
- frame counts n_len = (len_padded - 400) / 160 and
  n_len_org = 1 + (n_samples + 200 - 400) / 160.

``MelFrontend.device`` also reproduces the JAX package's device path: the
padded audio is bucketed to 30 s multiples and rounded to float16 before
the spectrogram (the JAX package ships PCM to the device as f16), which is
part of the function the golden transcripts depend on.  ``device_batch``
pads a batch of clips to the longest one's bucket and runs ONE K1 launch
over all of them, each clip normalized by its own maximum.  The host
ships only the clips' real f32 samples (on a CUDA device out of a pinned
buffer); the padding, the bucket and the f16 rounding are done on the
device by ``ops/mel_kernel.py::pad_stack``, bit for bit as ``pad_audio``
and numpy's f16 cast do them on the host.

The host versions are copied from the JAX package as numpy: the f64 oracle
``log_mel_np``, the streaming unit ``log_mel_frames_raw`` (raw log10 of a
range of frames) and the vectorized f32 ``log_mel_host``.  The JAX package
also computes the mel on the host when it measures a slow link to its
accelerator (``MelFrontend._host_mel`` / ``_link_bw``); the card here is
local, so K1 always runs on it, and there is no link probe.
``precompute_host_mels`` stays as a plain host function; nothing feeds its
result back into the device route.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import CHUNK_SECONDS, HOP_LENGTH, N_FFT, SAMPLE_RATE
from ..ops.mel_kernel import dft_basis, log_mel_raw, mel_tables, pad_stack

N_FFT_BINS = N_FFT // 2 + 1  # 201
_PAD = N_FFT // 2            # 200
_CHUNK = CHUNK_SECONDS * SAMPLE_RATE  # 480_000


def mel_filterbank(n_mels: int, n_fft: int = N_FFT,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale mel filterbank, shape (n_mels, n_fft//2+1) —
    librosa.filters.mel(norm="slaney", htk=False), as baked into the
    OpenAI Whisper checkpoints."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_bins)

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        mel = np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        hz = m * (200.0 / 3)
        log_region = m >= 15.0
        hz = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), hz)
        return hz

    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2),
                                    n_mels + 2))
    weights = np.zeros((n_mels, n_bins), dtype=np.float64)
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann (whisper.cpp:2712-2725 with periodic=true)."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


def pad_audio(samples: np.ndarray) -> np.ndarray:
    """Reference padding: reflect 200 at head, 30 s zeros + 400 at tail."""
    samples = np.asarray(samples, dtype=np.float32)
    n = len(samples)
    head = samples[1:_PAD + 1][::-1] if n > _PAD else np.concatenate(
        [samples[1:][::-1], np.zeros(_PAD - max(0, n - 1), dtype=np.float32)])
    tail = np.zeros(_CHUNK + _PAD, dtype=np.float32)
    return np.concatenate([head, samples, tail])


def frame_counts(n_samples: int) -> Tuple[int, int]:
    """(n_len, n_len_org) as computed at whisper.cpp:2832-2834."""
    padded = n_samples + _CHUNK + 2 * _PAD
    n_len = (padded - N_FFT) // HOP_LENGTH
    n_len_org = 1 + (n_samples + _PAD - N_FFT) // HOP_LENGTH
    return n_len, n_len_org


def normalize_log_mel(raw: torch.Tensor) -> torch.Tensor:
    """The clip-global max-8 clamp and (x + 4) / 4 (whisper.cpp:2855-2871)
    of a raw mel (n_mels, F), or of each clip of a batch (B, n_mels, F)."""
    mmax = raw.amax(dim=(-2, -1), keepdim=True) - 8.0
    return (torch.maximum(raw, mmax) + 4.0) / 4.0


# ---------------------------------------------------------------- numpy oracle
def log_mel_np(samples: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Float64 host oracle of the reference algorithm, (n_mels, n_len)."""
    filters = np.asarray(filters, dtype=np.float64)
    n_mels = filters.shape[0]
    padded = pad_audio(samples).astype(np.float64)
    n_len, _ = frame_counts(len(samples))
    window = hann_window().astype(np.float64)

    mel = np.full((n_mels, n_len), np.log10(1e-10))
    for i in range(n_len):
        frame = padded[i * HOP_LENGTH: i * HOP_LENGTH + N_FFT] * window
        spec = np.fft.rfft(frame, n=N_FFT)
        power = (spec.real ** 2 + spec.imag ** 2)[:N_FFT_BINS]
        mel[:, i] = np.log10(np.maximum(filters @ power, 1e-10))

    mmax = mel.max() - 8.0
    mel = np.maximum(mel, mmax)
    return ((mel + 4.0) / 4.0).astype(np.float32)


def log_mel_frames_raw(padded: np.ndarray, filters: np.ndarray,
                       i0: int, i1: int) -> np.ndarray:
    """Raw (un-normalized) log10 mel of frames [i0, i1) of an already
    padded sample stream, (n_mels, i1 - i0) f32: the incremental streaming
    unit of work.  A frame depends only on its own 400 samples; the
    clip-global clamp and normalization are applied later, over the whole
    clip (runtime/streaming.py).  Zero audio gives exactly log10(1e-10)."""
    filters = np.asarray(filters, dtype=np.float32)
    window = hann_window()
    n = i1 - i0
    frames = np.lib.stride_tricks.as_strided(
        padded[i0 * HOP_LENGTH:], shape=(n, N_FFT),
        strides=(padded.strides[0] * HOP_LENGTH, padded.strides[0]))
    spec = np.fft.rfft(frames * window, n=N_FFT, axis=1)
    power = np.abs(spec) ** 2
    return np.log10(np.maximum(power @ filters.T, 1e-10)).T.astype(
        np.float32)


def log_mel_host(samples: np.ndarray, filters: np.ndarray,
                 n_frames: Optional[int] = None) -> np.ndarray:
    """Vectorized f32 host mel, normalized, (n_mels, n_frames or n_len):
    the oracle's algorithm framed by stride tricks, one batched rfft and
    one matmul.  Frames past n_len hold the normalized floor."""
    filters = np.asarray(filters, dtype=np.float32)
    padded = pad_audio(samples)
    n_len, _ = frame_counts(len(samples))
    n_out = n_frames if n_frames is not None else n_len
    window = hann_window()

    n_use = min(n_out, n_len)
    frames = np.lib.stride_tricks.as_strided(
        padded, shape=(n_use, N_FFT),
        strides=(padded.strides[0] * HOP_LENGTH, padded.strides[0]))
    spec = np.fft.rfft(frames * window, n=N_FFT, axis=1)
    power = np.abs(spec) ** 2                              # (F, 201)
    mel = np.log10(np.maximum(power @ filters.T, 1e-10))   # (F, n_mels)
    mmax = mel.max() - 8.0
    out = np.empty((filters.shape[0], n_out), np.float32)
    out[:, :n_use] = ((np.maximum(mel, mmax) + 4.0) / 4.0).T
    if n_out > n_use:
        out[:, n_use:] = (max(np.log10(1e-10), mmax) + 4.0) / 4.0
    return out


def _bucket(n_padded: int) -> int:
    """Padded audio length rounded up to a 30 s multiple."""
    return -(-n_padded // _CHUNK) * _CHUNK


class MelFrontend:
    """Mel filterbank + DFT basis resident on one device, with kernel K1's
    tables derived from them once.  On a CUDA device a batch's samples
    are staged in one pinned buffer of ``STAGED`` samples, made at the
    first batch; a batch that outgrows it is copied from pageable memory
    (a long batch's copy takes 3x the host time that way: PERF.md)."""

    STAGED = 1 << 24   # 16.8 M samples: 32 clips of 30 s (15.36 M) fit

    def __init__(self, filters: np.ndarray, device):
        self.filters = np.asarray(filters, dtype=np.float32)
        self.n_mels = self.filters.shape[0]
        self.torch_device = torch.device(device)
        self._tables = mel_tables(
            torch.from_numpy(dft_basis()).to(self.torch_device),
            torch.from_numpy(self.filters).to(self.torch_device))
        self._staging: Optional[torch.Tensor] = None
        self._copied = None    # CUDA event after the last copy out of it
        self._lock = threading.Lock()

    def device(self, samples: np.ndarray, span=None
               ) -> Tuple[torch.Tensor, int]:
        """Device-resident mel: ((n_mels, bucketed_frames) f32, n_len), row
        0 of ``device_batch([samples])``."""
        mel, n_lens = self.device_batch([samples], span=span)
        return mel[0], n_lens[0]

    def device_batch(self, clips: Sequence[np.ndarray], span=None
                     ) -> Tuple[torch.Tensor, List[int]]:
        """Mel of a batch of clips on the device: ((B, n_mels, F) f32,
        [n_len per clip]).  Every clip is padded into the bucket of the
        longest, and one K1 launch covers the batch.  The clips' samples go
        to the device back to back, with each clip's offset and length;
        ``span`` (a tracer span) is given the bytes of samples shipped as
        ``h2d_bytes``."""
        clips = [np.asarray(c, dtype=np.float32) for c in clips]
        lens = [len(c) for c in clips]
        bucket = max(_bucket(n + _CHUNK + 2 * _PAD) for n in lens)
        index = torch.tensor([[0] + lens[:-1], lens], dtype=torch.int64)
        index[0] = index[0].cumsum(0)
        index = index.to(self.torch_device)
        flat = self._ship(clips, sum(lens))
        if span is not None:
            span.set(h2d_bytes=4 * flat.numel())
        stack = pad_stack(flat, index[0], index[1], bucket)
        mel = normalize_log_mel(log_mel_raw(stack, self._tables))
        return mel, [min(frame_counts(n)[0], mel.shape[2]) for n in lens]

    def _ship(self, clips: List[np.ndarray], n: int) -> torch.Tensor:
        """The clips' n samples back to back on the device: one
        non-blocking copy out of the pinned buffer, which waits for the
        last copy out of it to finish before it is rewritten."""
        dev = self.torch_device
        if dev.type != "cuda" or n > self.STAGED:
            return torch.from_numpy(np.concatenate(clips)).to(dev)
        with self._lock:
            if self._staging is None:
                self._staging = torch.empty(self.STAGED, dtype=torch.float32,
                                            pin_memory=True)
            elif self._copied is not None:
                self._copied.synchronize()
            np.concatenate(clips, out=self._staging.numpy()[:n])
            flat = self._staging[:n].to(dev, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(dev))
        return flat

    def precompute_host_mels(self, clips: Sequence[np.ndarray],
                             n_frames: Optional[int] = None
                             ) -> List[np.ndarray]:
        """Each clip's normalized f32 mel on the host (``log_mel_host``,
        f32 PCM, no f16 rounding) over the frame count ``device_batch``
        gives the same clips."""
        if n_frames is None:
            bucket = max(_bucket(len(c) + _CHUNK + 2 * _PAD) for c in clips)
            n_frames = (bucket - N_FFT) // HOP_LENGTH + 1
        return [log_mel_host(c, self.filters, n_frames=n_frames)
                for c in clips]

    def mel_len(self, n_samples: int) -> Tuple[int, int]:
        return frame_counts(n_samples)
