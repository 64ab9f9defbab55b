"""The one traffic generator: every cell's mix is parameters in its
workload file, read here.

Audio.  A pool of speech-like PCM is drawn on the device from the seed
(voiced segments of 0.2 s: a random pitch of 80-300 Hz with six harmonics
and a random loudness, plus a little noise), rounded to values float16
holds exactly (the program ships PCM to the card in float16, so both
sides see the same samples), and kept on the host.  A request's clip is a
slice of the pool at an offset drawn from the seed.

Batches.  Batch k of a run draws its clips from ``numpy`` seeded by (seed,
k): ``batch`` clips whose lengths are uniform in ``clip_seconds``
(a [min, max] pair).  Every seed gives the same sizes in a closed loop
(batches back to back), so the work of a run does not depend on the seed.

Labels (training).  Each row's label length is uniform in
``label_tokens``; the row is the task prefix, random text tokens below
end-of-text and end-of-text, padded to ``T`` under a zero mask.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

SAMPLE_RATE = 16000
_SEG = 3200  # 0.2 s voiced segments


def pool_pcm(seconds: float, seed: int, device) -> np.ndarray:
    """``seconds`` of speech-like float16-exact PCM as float32."""
    n_seg = int(math.ceil(seconds * SAMPLE_RATE / _SEG))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    u = torch.rand(3, n_seg, generator=gen, device=device,
                   dtype=torch.float64)
    f0 = (80.0 + 220.0 * u[0]).repeat_interleave(_SEG)
    amp = (0.03 + 0.25 * u[1] * (u[2] > 0.15)).repeat_interleave(_SEG)
    phase = torch.cumsum(2.0 * math.pi * f0 / SAMPLE_RATE, 0)
    x = sum(torch.sin(h * phase) / h for h in range(1, 7)) * amp
    x = x + 0.01 * torch.randn(x.shape, generator=gen, device=device,
                               dtype=torch.float64)
    x = x.clamp(-1.0, 1.0).to(torch.float16).to(torch.float32)
    return x.cpu().numpy()


class Request(NamedTuple):
    offset: int
    n: int


class Traffic:
    """Clips and labels of one run, from the workload's ``traffic``."""

    def __init__(self, spec: Dict, seed: int, device):
        self.spec = spec
        self.seed = int(seed)
        self.batch = int(spec["batch"])
        lo, hi = spec["clip_seconds"]
        self.n_range = (int(lo * SAMPLE_RATE), int(hi * SAMPLE_RATE))
        self.pcm = pool_pcm(float(spec["pool_seconds"]), seed, device)

    def _rng(self, k: int, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, k, stream])

    def requests(self, k: int) -> List[Request]:
        """Batch k's clips as (offset, length) into the pool."""
        rng = self._rng(k, 0)
        lo, hi = self.n_range
        ns = rng.integers(lo, hi + 1, self.batch)
        offs = rng.integers(0, len(self.pcm) - ns + 1)
        return [Request(int(o), int(n)) for o, n in zip(offs, ns)]

    def clip(self, r: Request) -> np.ndarray:
        return self.pcm[r.offset:r.offset + r.n]

    def clips(self, k: int) -> List[np.ndarray]:
        return [self.clip(r) for r in self.requests(k)]

    def labels(self, k: int, prefix: List[int], eot: int
               ) -> Dict[str, np.ndarray]:
        """Batch k's teacher-forced rows: tokens, targets (B, T) int32 and
        mask (B, T) f32."""
        rng = self._rng(k, 1)
        T = int(self.spec["T"])
        lo, hi = self.spec["label_tokens"]
        tokens = np.full((self.batch, T), eot, np.int32)
        targets = np.zeros((self.batch, T), np.int32)
        mask = np.zeros((self.batch, T), np.float32)
        for b in range(self.batch):
            n = int(rng.integers(lo, hi + 1))           # labels of this row
            text = rng.integers(0, eot, n - len(prefix)).tolist()
            seq = list(prefix) + text + [eot]            # n + 1 tokens
            tokens[b, :n] = seq[:n]
            targets[b, :n] = seq[1:n + 1]
            mask[b, :n] = 1.0
        return {"tokens": tokens, "targets": targets, "mask": mask}
