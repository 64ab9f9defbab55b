"""Sample-rate conversion — replaces libsamplerate's ``src_simple``
(libsamplerate src/samplerate.h:101, used by the
glue at godot-whisper src/speech_to_text.cpp:16-43) and exposes the same
five interpolator choices the Godot node exports
(src/speech_to_text.h:151-157): SINC_BEST / SINC_MEDIUM / SINC_FASTEST /
ZERO_ORDER_HOLD / LINEAR.

Design: polyphase Kaiser-windowed-sinc FIR at a rational rate L/M, in
vectorized NumPy (gather + dot) on the host.  Quality tiers map to filter
half-lengths (sinc_best 64 taps/phase, medium 32, fastest 16).  A copy of
the JAX package's ``audio/resample.py``, which is framework-neutral.
"""

from __future__ import annotations

import enum
import functools
import math
from typing import Tuple

import numpy as np


class Interpolator(enum.Enum):
    SINC_BEST = 0
    SINC_MEDIUM = 1
    SINC_FASTEST = 2
    ZERO_ORDER_HOLD = 3
    LINEAR = 4


_TAPS_PER_PHASE = {
    Interpolator.SINC_BEST: 64,
    Interpolator.SINC_MEDIUM: 32,
    Interpolator.SINC_FASTEST: 16,
}


def mixdown(buffer: np.ndarray) -> np.ndarray:
    """Stereo (N, 2) -> mono, (l+r)/2 (src/speech_to_text.cpp:45-51)."""
    x = np.asarray(buffer, dtype=np.float32)
    if x.ndim == 2:
        return x.mean(axis=1)
    return x


@functools.lru_cache(maxsize=32)
def _polyphase_bank(L: int, M: int, taps_per_phase: int,
                    beta: float = 8.6) -> np.ndarray:
    """(L, taps_per_phase) polyphase decomposition of a Kaiser lowpass at
    cutoff min(1/L, 1/M)."""
    n_taps = L * taps_per_phase
    cutoff = min(1.0 / L, 1.0 / M)
    n = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(n_taps, beta)
    h *= L  # gain compensation for zero-stuffing
    # phase p of the polyphase bank: h[p::L]
    bank = np.zeros((L, taps_per_phase), dtype=np.float64)
    for p in range(L):
        taps = h[p::L]
        bank[p, :len(taps)] = taps
    return bank.astype(np.float32)


def _rational_ratio(src_rate: int, dst_rate: int,
                    max_den: int = 1000) -> Tuple[int, int]:
    from fractions import Fraction
    fr = Fraction(dst_rate, src_rate).limit_denominator(max_den)
    return fr.numerator, fr.denominator


def resample(
    x: np.ndarray,
    src_rate: int,
    dst_rate: int,
    interpolator: Interpolator = Interpolator.SINC_FASTEST,
) -> np.ndarray:
    """One-shot resample (the ``src_simple`` call shape).

    Output length follows ceil(n * dst/src), matching libsamplerate's
    one-shot behavior closely enough for streaming use.
    """
    x = mixdown(x)
    if src_rate == dst_rate:
        return np.asarray(x, dtype=np.float32)

    n_out = int(math.ceil(len(x) * dst_rate / src_rate))

    if interpolator == Interpolator.ZERO_ORDER_HOLD:
        idx = np.minimum((np.arange(n_out) * src_rate) // dst_rate,
                         len(x) - 1).astype(np.int64)
        return x[idx].astype(np.float32)

    if interpolator == Interpolator.LINEAR:
        pos = np.arange(n_out, dtype=np.float64) * src_rate / dst_rate
        i0 = np.minimum(pos.astype(np.int64), len(x) - 1)
        i1 = np.minimum(i0 + 1, len(x) - 1)
        frac = (pos - i0).astype(np.float32)
        return ((1.0 - frac) * x[i0] + frac * x[i1]).astype(np.float32)

    # polyphase sinc
    L, M = _rational_ratio(src_rate, dst_rate)
    # (after the ratio, output index k corresponds to input phase arithmetic
    #  k*M = q*L + r  ->  take phase r at input offset q)
    taps = _TAPS_PER_PHASE[interpolator]
    bank = _polyphase_bank(L, M, taps)
    half = taps // 2

    k = np.arange(n_out, dtype=np.int64)
    kM = k * M
    q = kM // L
    r = (kM % L).astype(np.int64)

    # gather windows of length `taps` ending at q+half
    pad = taps
    xp = np.pad(x.astype(np.float32), (pad, pad))
    starts = q + pad - half - (taps % 2)
    win_idx = starts[:, None] + np.arange(taps)[None, :]
    windows = xp[win_idx]                       # (n_out, taps)
    phases = bank[r]                            # (n_out, taps)
    # correlation against the time-reversed filter phase
    return np.einsum("nt,nt->n", windows, phases[:, ::-1]).astype(np.float32)


def resample_simple(buffer: np.ndarray, mix_rate: int,
                    interpolator: int = 2) -> np.ndarray:
    """The glue-level entry: stereo mixdown + mix_rate -> 16 kHz
    (SpeechToText::resample, src/speech_to_text.cpp:353-376)."""
    return resample(mixdown(buffer), mix_rate, 16000,
                    Interpolator(interpolator))
