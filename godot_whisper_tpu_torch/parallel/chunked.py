"""Audio-chunk parallelism, ``whisper_full_parallel``
(whisper.cpp:5817-5930), port of the JAX package's ``parallel/chunked.py``.

The reference runs one host thread and one whisper_state per contiguous
chunk of the audio.  Here the chunks are the streams of one batch
(``parallel/batch.py``): every chunk's seek loop decodes at once, beam and
best_of included, and host-interactive modes fall back to one chunk after
another with the same merge.  Chunk boundaries keep the reference's
behaviour: each chunk's timestamps are offset by its start
(whisper.cpp:5877-5896), and the same boundary caveat holds (:5927).
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import List

import numpy as np

from ..decode.params import TranscribeParams
from ..models.config import SAMPLE_RATE


def full_parallel(pipeline, tparams: TranscribeParams,
                  samples: np.ndarray, n_processors: int) -> List:
    """Split ``samples`` into ``n_processors`` contiguous chunks, decode
    them as one batch and merge their segments with each chunk's time
    offset (whisper.cpp:5877-5919)."""
    if n_processors <= 1:
        return pipeline.full(tparams, samples)

    n = len(samples)
    offset_samples = (SAMPLE_RATE * tparams.offset_ms) // 1000
    per = (n - offset_samples) // n_processors
    starts = [offset_samples + i * per for i in range(n_processors)]
    ends = [n if i == n_processors - 1 else starts[i] + per
            for i in range(n_processors)]
    chunks = [np.asarray(samples[s:e]) for s, e in zip(starts, ends)]

    p = copy.copy(tparams)
    p.offset_ms = 0        # the chunking applied the offset
    # duration_ms goes into every chunk's decode unchanged: the reference
    # copies the params whole per worker (whisper.cpp:5845-5853)
    p.print_progress = False

    from .batch import BatchTranscriber
    bt = BatchTranscriber(SimpleNamespace(pipeline=pipeline))
    all_segments = []
    for i, segs in enumerate(bt.transcribe(chunks, p)):
        offset_t = (100 * starts[i]) // SAMPLE_RATE
        for s in segs:
            s2 = copy.deepcopy(s)
            s2.t0 += offset_t
            s2.t1 += offset_t
            all_segments.append(s2)
    pipeline.segments = all_segments
    return all_segments
