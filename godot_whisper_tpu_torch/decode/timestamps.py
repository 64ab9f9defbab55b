"""Token-level timestamps + segment wrapping.

Port of the reference's experimental heuristic
(``whisper_exp_compute_token_level_timestamps``,
whisper.cpp:6315-6599) and
``whisper_wrap_segment`` (whisper.cpp:4421-4480):

1. anchor tokens whose timestamp prediction is confident
   (pt > thold_pt, ptsum > thold_ptsum, monotonic, within segment);
2. proportionally split unknown intervals by a "voice length" heuristic;
3. expand/contract token boundaries using a signal-energy VAD.

The O(n_samples * window) energy loop of the reference is replaced by a
cumulative-sum sliding mean (identical result, linear time).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.config import SAMPLE_RATE


def signal_energy(signal: np.ndarray, half_window: int = 32) -> np.ndarray:
    """Sliding mean of |signal| (get_signal_energy, whisper.cpp:6350-6366).

    Exactly matches the reference's truncated-window edges: the divisor is
    always (2*hw+1) even at the boundaries.
    """
    x = np.abs(np.asarray(signal, dtype=np.float32))
    n = len(x)
    hw = half_window
    cs = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    i = np.arange(n)
    lo = np.maximum(i - hw, 0)
    hi = np.minimum(i + hw + 1, n)
    return ((cs[hi] - cs[lo]) / (2 * hw + 1)).astype(np.float32)


def _voice_length(text: str) -> float:
    """Pronunciation-time heuristic (whisper.cpp:6325-6347)."""
    res = 0.0
    for c in text:
        if c == " ":
            res += 0.01
        elif c == ",":
            res += 2.0
        elif c in ".!?":
            res += 3.0
        elif "0" <= c <= "9":
            res += 3.0
        else:
            res += 1.0
    return res


def _ts_to_sample(t: float, n_samples: int) -> int:
    return max(0, min(n_samples - 1, int((t * SAMPLE_RATE) // 100)))


def _sample_to_ts(i: int) -> int:
    return (100 * i) // SAMPLE_RATE


def compute_token_level_timestamps(pipeline, i_segment: int,
                                   thold_pt: float, thold_ptsum: float
                                   ) -> None:
    """Fill t0/t1/vlen of every token of ``pipeline.segments[i_segment]``."""
    segment = pipeline.segments[i_segment]
    tokens = segment.tokens
    energy = getattr(pipeline, "_energy", None)
    if energy is None or len(energy) == 0:
        return

    n_samples = len(energy)
    t0s, t1s = segment.t0, segment.t1
    n = len(tokens)
    if n == 0:
        return
    if n == 1:
        tokens[0].t0, tokens[0].t1 = t0s, t1s
        return

    config = pipeline.config
    token_beg = config.token_beg
    token_eot = config.token_eot

    # persistent anchors across segments (state.t_beg/t_last/tid_last)
    st = pipeline._ts_state

    for j, token in enumerate(tokens):
        if j == 0:
            if token.id == token_beg:
                tokens[0].t0 = t0s
                tokens[0].t1 = t0s
                tokens[1].t0 = t0s
                st["t_beg"] = t0s
                st["t_last"] = t0s
                st["tid_last"] = token_beg
            else:
                tokens[0].t0 = st["t_last"]

        tt = st["t_beg"] + 2 * (token.tid - token_beg)
        token.vlen = _voice_length(pipeline.tokenizer.token_str(token.id))

        if (token.pt > thold_pt and token.ptsum > thold_ptsum
                and token.tid > st["tid_last"] and tt <= t1s):
            if j > 0:
                tokens[j - 1].t1 = tt
            token.t0 = tt
            st["tid_last"] = token.tid

    tokens[n - 2].t1 = t1s
    tokens[n - 1].t0 = t1s
    tokens[n - 1].t1 = t1s
    st["t_last"] = t1s

    # proportional split of unknown intervals (whisper.cpp:6446-6488)
    p0 = 0
    while True:
        p1 = p0
        while p1 < n and tokens[p1].t1 < 0:
            p1 += 1
        if p1 >= n:
            p1 = n - 1
        if p1 > p0:
            psum = sum(tokens[j].vlen for j in range(p0, p1 + 1))
            dt = tokens[p1].t1 - tokens[p0].t0
            if psum > 0:
                for j in range(p0 + 1, p1 + 1):
                    ct = tokens[j - 1].t0 + dt * tokens[j - 1].vlen / psum
                    tokens[j - 1].t1 = int(ct)
                    tokens[j].t0 = int(ct)
        p1 += 1
        p0 = p1
        if p1 >= n:
            break

    # fix-up pass (whisper.cpp:6491-6502)
    for j in range(n - 1):
        if tokens[j].t1 < 0:
            tokens[j + 1].t0 = tokens[j].t1
        if j > 0 and tokens[j - 1].t1 > tokens[j].t0:
            tokens[j].t0 = tokens[j - 1].t1
            tokens[j].t1 = max(tokens[j].t0, tokens[j].t1)

    # energy-VAD boundary expansion/contraction (whisper.cpp:6504-6572)
    hw = SAMPLE_RATE // 8
    for j in range(n):
        if tokens[j].id >= token_eot:
            continue
        s0 = _ts_to_sample(tokens[j].t0, n_samples)
        s1 = _ts_to_sample(tokens[j].t1, n_samples)
        ss0 = max(s0 - hw, 0)
        ss1 = min(s1 + hw, n_samples)
        ns = ss1 - ss0
        if ns <= 0:
            continue
        thold = 0.5 * float(energy[ss0:ss1].sum()) / ns

        k = s0
        if energy[k] > thold and j > 0:
            while k > 0 and energy[k] > thold:
                k -= 1
            tokens[j].t0 = _sample_to_ts(k)
            if tokens[j].t0 < tokens[j - 1].t1:
                tokens[j].t0 = tokens[j - 1].t1
            else:
                s0 = k
        else:
            while k < s1 and energy[k] < thold:
                k += 1
            s0 = k
            tokens[j].t0 = _sample_to_ts(k)

        k = s1
        if energy[k] > thold:
            while k < n_samples - 1 and energy[k] > thold:
                k += 1
            tokens[j].t1 = _sample_to_ts(k)
            # upstream compares j against `ns` (the VAD window sample count,
            # whisper.cpp:6558) which is surely meant to be the token count;
            # in C++ the j+1 == n read is silent OOB — here it must be
            # guarded explicitly.
            if j < ns - 1 and j + 1 < n and tokens[j].t1 > tokens[j + 1].t0:
                tokens[j].t1 = tokens[j + 1].t0
            else:
                s1 = k
        else:
            while k > s0 and energy[k] < thold:
                k -= 1
            s1 = k
            tokens[j].t1 = _sample_to_ts(k)


def _should_split_on_word(txt: str, split_on_word: bool) -> bool:
    if not split_on_word:
        return True
    return txt.startswith(" ")


def wrap_segment(pipeline, max_len: int, split_on_word: bool) -> int:
    """Re-split the last segment at max_len characters
    (whisper_wrap_segment, whisper.cpp:4429-4480).  Returns the number of
    segments the original expanded into."""
    from .loop import Segment

    segment = pipeline.segments[-1]
    res = 1
    acc = 0
    text = ""

    tokens = segment.tokens
    i = 0
    while i < len(tokens):
        token = tokens[i]
        if token.id >= pipeline.config.token_eot:
            i += 1
            continue
        txt = pipeline.tokenizer.token_str(token.id)
        cur = len(txt.encode("utf-8"))
        if (acc + cur > max_len and i > 0
                and _should_split_on_word(txt, split_on_word)):
            last = pipeline.segments[-1]
            last.text = text
            last.t1 = token.t0
            last.tokens = tokens[:i]
            last.speaker_turn_next = False

            new_seg = Segment(t0=token.t0, t1=segment.t1, text="",
                              tokens=tokens[i:],
                              speaker_turn_next=segment.speaker_turn_next)
            pipeline.segments.append(new_seg)
            segment = new_seg
            tokens = new_seg.tokens
            acc = 0
            text = ""
            i = 0
            res += 1
        else:
            acc += cur
            text += txt
            i += 1

    pipeline.segments[-1].text = text
    return res
