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
part of the function the golden transcripts depend on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.config import CHUNK_SECONDS, HOP_LENGTH, N_FFT, SAMPLE_RATE
from ..ops.mel_kernel import dft_basis, log_mel_raw, mel_tables

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
    """The clip-global max-8 clamp and (x + 4) / 4 (whisper.cpp:2855-2871)."""
    return (torch.maximum(raw, raw.max() - 8.0) + 4.0) / 4.0


class MelFrontend:
    """Mel filterbank + DFT basis resident on one device, with kernel K1's
    tables derived from them once."""

    def __init__(self, filters: np.ndarray, device):
        self.filters = np.asarray(filters, dtype=np.float32)
        self.n_mels = self.filters.shape[0]
        self.torch_device = torch.device(device)
        self._tables = mel_tables(
            torch.from_numpy(dft_basis()).to(self.torch_device),
            torch.from_numpy(self.filters).to(self.torch_device))

    def device(self, samples: np.ndarray) -> Tuple[torch.Tensor, int]:
        """Device-resident mel: ((n_mels, bucketed_frames) f32, n_len)."""
        samples = np.asarray(samples, dtype=np.float32)
        n_len, _ = frame_counts(len(samples))
        padded = pad_audio(samples)
        bucket = -(-len(padded) // _CHUNK) * _CHUNK
        padded = np.pad(padded, (0, bucket - len(padded)))
        audio = torch.from_numpy(padded.astype(np.float16)).to(
            self.torch_device)
        raw = log_mel_raw(audio[None], self._tables)[0]
        mel = normalize_log_mel(raw)
        return mel, min(n_len, mel.shape[1])
