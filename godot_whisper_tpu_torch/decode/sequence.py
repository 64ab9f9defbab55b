"""Sequence scoring: length-penalized logprob sum + token-histogram entropy.

Mirrors ``whisper_sequence_score``
(whisper.cpp:4912-4958).
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class SequenceScore:
    sum_logprobs: float
    avg_logprobs: float
    entropy: float
    score: float


def score_sequence(token_ids: Sequence[int], plogs: Sequence[float],
                   length_penalty: float) -> SequenceScore:
    """Score a finalized token sequence.

    - score = sum(plog) / penalty with the Google length penalty
      ((5+n)/6)^alpha when alpha > 0, else plain length (whisper.cpp:4928-4934)
    - entropy of the final 32 tokens' id histogram (whisper.cpp:4936-4957)
    """
    n = len(token_ids)
    if n == 0:
        return SequenceScore(-math.inf, -math.inf, 0.0, -math.inf)

    total = float(np.sum(np.asarray(plogs[:n], dtype=np.float64)))
    avg = total / n

    penalty = float(n)
    if length_penalty > 0.0:
        penalty = ((5.0 + n) / 6.0) ** length_penalty

    counts = Counter(token_ids[max(0, n - 32):n])
    cnt = sum(counts.values())
    entropy = -sum((c / cnt) * math.log(c / cnt) for c in counts.values())

    return SequenceScore(sum_logprobs=total, avg_logprobs=avg,
                         entropy=entropy, score=total / penalty)
