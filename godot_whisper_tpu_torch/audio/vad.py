"""Energy-based voice-activity detection, copied from the JAX package's
``audio/vad.py`` (numpy only).

Port of the glue's ``_vad_simple`` + ``_high_pass_filter``
(godot-whisper src/speech_to_text.cpp:53-104, itself lifted from the
whisper.cpp stream example): a first-order high-pass pre-filter, then a
"speech ended?" test comparing the mean |x| of the trailing ``last_ms``
window against the whole-buffer mean.

Faithfulness note: the reference filter mutates its buffer IN PLACE while
reading ``data[i-1]`` (speech_to_text.cpp:57-64), so the recursion
``y[i] = alpha*(y[i-1] + data[i] - data[i-1])`` actually reads the
*already-filtered* previous sample and algebraically collapses to
``y[i] = alpha * x[i]`` for i >= 1 (y[0] = x[0]).  We reproduce that exact
observable behavior — the VAD energy-ratio decision depends only on the
uniform alpha scaling, so intended-vs-actual filter makes no practical
difference, but bit-faithful is bit-faithful.
"""

from __future__ import annotations

import numpy as np


def high_pass_filter(data: np.ndarray, cutoff: float,
                     sample_rate: float) -> np.ndarray:
    """The reference's in-place first-order high-pass
    (speech_to_text.cpp:53-65); see the module docstring for why this is a
    plain scale for i >= 1."""
    x = np.asarray(data, dtype=np.float32)
    if len(x) == 0:
        return x.copy()
    rc = 1.0 / (2.0 * np.pi * cutoff)
    dt = 1.0 / sample_rate
    alpha = np.float32(dt / (rc + dt))

    y = alpha * x
    y[0] = x[0]
    return y


def vad_simple(pcmf32: np.ndarray, sample_rate: int = 16000,
               last_ms: int = 1000, vad_thold: float = 0.3,
               freq_thold: float = 200.0, verbose: bool = False) -> bool:
    """True when speech appears to have ENDED (speech_to_text.cpp:67-104).

    Returns False when the buffer is too short, energetic throughout, or the
    trailing window still carries energy above ``vad_thold`` x overall.
    """
    x = np.asarray(pcmf32, dtype=np.float32)
    n_samples = len(x)
    n_last = (sample_rate * last_ms) // 1000

    if n_last >= n_samples:
        return False  # not enough samples — assume no speech end

    if freq_thold > 0.0:
        x = high_pass_filter(x, freq_thold, sample_rate)

    ax = np.abs(x)
    energy_all = float(ax.mean())
    energy_last = float(ax[n_samples - n_last:].mean()) if n_last else 0.0

    if verbose:
        print(f"vad: energy_all={energy_all:.6f} "
              f"energy_last={energy_last:.6f} thold={vad_thold}")

    # NOTE: reproduces the reference's exact (peculiar) condition at
    # speech_to_text.cpp:100-103: "ended" fires only when the WHOLE buffer
    # is near-silent (< 1e-4 mean |x|) AND the tail is below the threshold
    # ratio.  (The upstream whisper.cpp stream example checks only the
    # ratio; the godot glue added the silence requirement.)
    if (not (energy_all < 1e-4 and energy_last < 1e-4)
            or energy_last > vad_thold * energy_all):
        return False
    return True
