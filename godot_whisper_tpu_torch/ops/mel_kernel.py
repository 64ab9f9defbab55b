"""K1: raw log-mel spectrogram (csrc/mel.cu) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/mel_kernel.py`` (TPU kernel
``_mel_kernel``): frames of 400 samples at hop 160 from f16 audio, the
periodic-Hann windowed DFT, power over 201 bins, the mel filterbank,
``log10(max(x, 1e-10))``.  The clip-global max-8 clamp and ``(x + 4) / 4``
stay outside the kernel (audio/mel.py), as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.config import HOP_LENGTH, N_FFT
from . import kernels as K

N_FFT_BINS = N_FFT // 2 + 1  # 201


@functools.lru_cache(maxsize=1)
def dft_basis() -> np.ndarray:
    """(400, 2 * 201) f32: hann * cos | -hann * sin, built in f64 from the
    f32 periodic Hann window, exactly as the JAX package's
    ``_windowed_dft_basis``."""
    n = np.arange(N_FFT, dtype=np.float64)[:, None]
    k = np.arange(N_FFT_BINS, dtype=np.float64)[None, :]
    theta = 2.0 * np.pi * n * k / N_FFT
    win = (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
           ).astype(np.float32).astype(np.float64)[:, None]
    return np.concatenate([np.cos(theta) * win, -np.sin(theta) * win],
                          axis=1).astype(np.float32)


def log_mel_raw_plain(audio: torch.Tensor, basis: torch.Tensor,
                      filters: torch.Tensor) -> torch.Tensor:
    """(B, L) f16 audio -> (B, n_mels, F) f32 raw log10 mel,
    F = (L - 400) // 160 + 1."""
    frames = audio.float().unfold(-1, N_FFT, HOP_LENGTH)   # (B, F, 400)
    spec = frames @ basis                                  # (B, F, 402)
    re, im = spec[..., :N_FFT_BINS], spec[..., N_FFT_BINS:]
    power = re * re + im * im
    mel = power @ filters.T                                # (B, F, n_mels)
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


def log_mel_raw(audio: torch.Tensor, basis: torch.Tensor,
                filters: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: CUDA tensors launch csrc/mel.cu, CPU tensors take
    the plain version.  audio (B, L) f16; basis (400, 402) f32; filters
    (n_mels, 201) f32."""
    if audio.device.type == "cpu":
        return log_mel_raw_plain(audio, basis, filters)
    K.require_cuda("log_mel_raw", audio, basis, filters)
    B, L = audio.shape
    n_mels = filters.shape[0]
    if (audio.dtype != torch.float16 or basis.dtype != torch.float32
            or filters.dtype != torch.float32
            or tuple(basis.shape) != (N_FFT, 2 * N_FFT_BINS)
            or filters.shape[1] != N_FFT_BINS or L < N_FFT):
        raise ValueError("log_mel_raw: audio (B, L>=400) f16, basis "
                         "(400, 402) f32, filters (n_mels, 201) f32")
    n_frames = (L - N_FFT) // HOP_LENGTH + 1
    out = torch.empty((B, n_mels, n_frames), dtype=torch.float32,
                      device=audio.device)
    fn = K.entry("mel", "gwt_mel", (K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.I,
                                    K.P))
    K.launch(fn, "gwt_mel", audio.data_ptr(), basis.data_ptr(),
             filters.data_ptr(), out.data_ptr(), B, L, n_frames, n_mels,
             K.stream_ptr(audio.device))
    log_mel_raw.launches += 1
    return out


log_mel_raw.launches = 0
