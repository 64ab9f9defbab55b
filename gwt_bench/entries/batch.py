"""Entry kind "batch": ``BatchTranscriber.transcribe`` over a closed loop
of batches, each of fresh clips from the seed.

The window runs batch after batch until ``seconds`` have passed; it ends
with the last batch, so every batch started is completed and counted.
Batch k of a run is the traffic's batch k whichever window runs it.
``audio_s_per_s`` is the audio of all batches over that time.

``correct``: every request of the run is answered with as many tokens as
the parameters ask (``short_requests``: a window that never meets
end-of-text stops after ``max_tokens`` + 1 tokens, and the weights make
end-of-text lose: see the configuration's ``eot_embed_scale``); and over a
sample of the requests drawn from the seed, with the longest clip in it,
the plain reference run teacher-forced over each prompt and its served
tokens gives two numbers: the widest gap by which a served token's
log-probability lies below the reference's best allowed one
(``widest_gap``: the token greedy would not have chosen), and the mean
fourth power of the gap between the program's log-probability of each
served token and the reference's (``logprob_m4``).  PERF.md gives the
readings each limit was set from.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import reference, weights
from ..traffic import SAMPLE_RATE, Traffic
from . import port_config

WARMUP_BATCHES = 2
_WARMUP_K = 1 << 20        # batch indices of the warm-up, apart from the window's


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Entry:
    E2E = {"audio_s_per_s": "audio-s/s"}

    def __init__(self, cfg: dict, spec: dict, seed: int, device):
        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.attempted = self.failed = 0

    def setup(self) -> None:
        import godot_whisper_tpu_torch as gt
        from godot_whisper_tpu_torch.audio.tokenizer import Tokenizer
        from godot_whisper_tpu_torch.parallel.batch import BatchTranscriber

        cfg, spec = self.cfg, self.spec
        self.wcfg = port_config(cfg)
        self.params = weights.draw(cfg, self.seed, self.device,
                                   float(cfg.get("eot_embed_scale", 1.0)))
        self.vocab = weights.vocabulary(cfg)
        self.filters = weights.filterbank(cfg)
        self.ctx = gt.WhisperContext.from_params(
            self.wcfg, self.params, device=self.device,
            tokenizer=Tokenizer(self.wcfg, self.vocab),
            mel_filters=self.filters, quantize=spec.get("quantize"))
        self.bt = BatchTranscriber(self.ctx)
        p = dict(spec["params"])
        if "strategy" in p:
            p["strategy"] = gt.SamplingStrategy[p["strategy"].upper()]
        self.tparams = gt.TranscribeParams(**p)
        self.traffic = Traffic(spec["traffic"], self.seed, self.device)
        self.served: List[List[List[int]]] = []   # by batch, clip: ids
        self.plogs: List[List[List[float]]] = []  # and their log-probs
        for j in range(WARMUP_BATCHES):
            self.bt.transcribe(self.traffic.clips(_WARMUP_K + j), self.tparams)
        _sync(self.device)

    def window(self, seconds: float):
        """Batches back to back until ``seconds`` have passed.  A second
        call goes on with the next batches of the same run."""
        tm = self.ctx.timings
        n_decode0, n_encode0 = tm.n_decode, tm.n_encode
        k0 = len(self.served)
        t0 = t = time.perf_counter()
        unit_s = []
        while True:
            self.record(self.bt.transcribe(
                self.traffic.clips(len(self.served)), self.tparams))
            unit_s.append(time.perf_counter() - t)
            t += unit_s[-1]
            if t - t0 >= seconds:
                break
        t1 = t
        ks = range(k0, len(self.served))
        reqs = [r for j in ks for r in self.traffic.requests(j)]
        audio_s = sum(r.n for r in reqs) / SAMPLE_RATE
        want = int(self.tparams.max_tokens) + 1
        counts = [len(t) for j in ks for t in self.served[j]]
        self.attempted += len(reqs)
        self.failed += sum(1 for n in counts if n != want)
        facts = {"units": len(ks), "unit_s": unit_s, "window_s": t1 - t0,
                 "rows": self.traffic.batch,
                 "windows": len(reqs),
                 "prompt": len(self.cfg["task_prefix"]),
                 "served_tokens": counts,
                 "decode_steps": tm.n_decode - n_decode0,
                 "encoder_waves": tm.n_encode - n_encode0,
                 "audio_s": audio_s}
        return {"audio_s_per_s": audio_s / (t1 - t0)}, facts

    def record(self, segs) -> None:
        """Keep a batch's answers: each clip's token ids and the program's
        log-probability of each."""
        self.served.append([[t.id for s in c for t in s.tokens]
                            for c in segs])
        self.plogs.append([[t.plog for s in c for t in s.tokens]
                           for c in segs])

    def release(self) -> None:
        """Drop the program's state; the weights stay (the benchmark's
        own, which the reference reads)."""
        self.bt = self.ctx = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ checking
    def sample(self) -> List[tuple]:
        """(batch, row) of the requests compared: the longest clip, then
        others drawn from the seed."""
        chk = self.spec["check"]
        pairs = [(k, b) for k in range(len(self.served))
                 for b in range(len(self.served[k]))]
        n = {(k, b): self.traffic.requests(k)[b].n for k, b in pairs}
        longest = max(pairs, key=lambda kb: (n[kb], -kb[0], -kb[1]))
        rest = [kb for kb in pairs if kb != longest]
        rng = np.random.default_rng([self.seed, 0xC4EC])
        take = min(int(chk["sample_requests"]) - 1, len(rest))
        picked = [rest[i] for i in sorted(rng.choice(len(rest), take,
                                                     replace=False))]
        return [longest] + picked

    def compared(self, mode: str = "f32") -> Dict[str, np.ndarray]:
        """Over the sample, concatenated: each served token's gap below the
        reference's best allowed logit, and the gap between the program's
        log-probability of it and the reference's; with ``mode`` another
        precision, the reference at it put in the program's place (its
        choice's gap, its log-probabilities at the served tokens)."""
        pick = self.sample()
        reqs = {k: self.traffic.requests(k) for k in {k for k, _ in pick}}
        mels = torch.stack([
            reference.mel_window(self.traffic.clip(reqs[k][b]), self.filters,
                                 self.device) for k, b in pick])
        prompts = [list(self.cfg["task_prefix"])] * len(pick)
        served = [self.served[k][b] for k, b in pick]
        sid = weights.space_id(self.vocab)
        gaps, lp_gaps = [], []
        with torch.no_grad(), reference.precision("f32"):
            ref = reference.served_logprobs(
                reference.Reference(self.params, self.cfg), mels, prompts,
                served, sid)
        if mode != "f32":
            with torch.no_grad(), reference.precision(mode):
                low = reference.served_logprobs(
                    reference.Reference(self.params, self.cfg, mode), mels,
                    prompts, served, sid)
        with torch.no_grad():
            for j, (k, b) in enumerate(pick):
                if mode == "f32":
                    gap, lp = reference.token_numbers(ref[j], served[j])
                    prog = np.asarray(self.plogs[k][b], np.float64)
                else:
                    choice = low[j].argmax(-1).tolist()
                    gap, _ = reference.token_numbers(ref[j], choice)
                    _, lp = reference.token_numbers(ref[j], served[j])
                    _, prog = reference.token_numbers(low[j], served[j])
                gaps.append(gap)
                lp_gaps.append(np.abs(prog - lp))
        return {"gap": np.concatenate(gaps), "logprob_gap":
                np.concatenate(lp_gaps)}

    def check(self, mode: str = "f32"):
        """The numbers that decide ``correct``, each with its limit; with
        ``mode`` another precision, those of the reference at it put in the
        program's place (a control)."""
        lim = self.spec["check"]["limits"]
        c = self.compared(mode)
        gap, d = c["gap"], c["logprob_gap"]
        return [("short_requests", float(self.failed),
                 float(lim["short_requests"])),
                ("widest_gap", float(gap.max()) if gap.size else float("inf"),
                 float(lim["widest_gap"])),
                ("logprob_m4", float(np.mean(d ** 4)) if d.size
                 else float("inf"), float(lim["logprob_m4"]))]
