"""Per-pipeline timing metrics.

Mirror of the stage timers and failure counters in ``whisper_state``
(whisper.cpp:770-783) and
``whisper_print_timings`` (whisper.cpp:3793-3832).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Timings:
    t_mel_us: int = 0
    t_encode_us: int = 0
    t_decode_us: int = 0
    t_load_us: int = 0

    n_encode: int = 0
    n_decode: int = 0

    # temperature-fallback counters (whisper.cpp:782-783)
    n_fail_p: int = 0  # avg-logprob gate failures
    n_fail_h: int = 0  # entropy ("hallucination") gate failures

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def report(self) -> str:
        lines = [
            f"load time   = {self.t_load_us / 1000.0:8.2f} ms",
            f"mel time    = {self.t_mel_us / 1000.0:8.2f} ms",
            (f"encode time = {self.t_encode_us / 1000.0:8.2f} ms / "
             f"{self.n_encode} runs"),
            (f"decode time = {self.t_decode_us / 1000.0:8.2f} ms / "
             f"{self.n_decode} steps"),
            f"fallbacks   = {self.n_fail_p:3d} p / {self.n_fail_h:3d} h",
        ]
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
