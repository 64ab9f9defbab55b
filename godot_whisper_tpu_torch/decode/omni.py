"""Batched speech-to-text through a decoder-only audio LM
(``models/unimoe.py``): the context ``BatchTranscriber`` serves it through.

A batch runs, for every 20 s chunk of every clip (one row each):

1. K1: the log-mel of every row in one launch (``MelFrontend.device_batch``);
2. the Whisper encoder (K2) over each row's 30 s window: the chunk's
   log-mel with the 30 s of padding in it, as Whisper's feature extractor
   pads a chunk (no frame zeroed);
3. the connector: 200 audio tokens a row;
4. one prefill of ``[prompt head | audio tokens | prompt tail]`` through the
   LM, which fills the grouped-query K/V cache; the routed experts run
   over the tokens gathered for each (``gwt.prefill``);
5. greedy steps: K5 on the logits (the LM's ids: no timestamp ids, no
   suppression), one device -> host transfer a step, then the LM's step
   (``models/unimoe.py::lm_step``) for the next logits.  On one CUDA
   device the step is one CUDA graph of the batch's shape (``LMStepGraph``),
   replayed every step after one upload of its tokens, positions and
   cache slot; elsewhere it runs eagerly.

Whisper's task tokens, timestamp rule and blank suppression do not apply:
a row ends at end-of-text (the model's ``<|im_end|>``) or after
``max_tokens`` + 1 tokens.  The step adds its routing counts (token-layers,
routed experts run, null picks, routed experts that some row chose) to a
device buffer that rides home with each step's transfer, so the token
loop's span gets them without a sync of its own.  With ``record_routes``
the step also writes its chosen sets into the graph's ``routes`` buffer
by cache slot, beside the prefill's; they stay on the device
(``UniMoEContext.last_routes``), for a check to route a reference by
them.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..audio.mel import MelFrontend
from ..models import unimoe
from ..models.model import encoder_forward, round_cache_len
from ..ops import kernels as K
from ..ops.filter_sample import fused_filter_sample
from ..runtime.metrics import Timings
from ..runtime.trace import tracer
from .loop import Segment, TokenData
from .params import TranscribeParams
from .window import GraphedStep, StepCache

WINDOW_FRAMES = 3000                 # the encoder's 30 s window of mel frames


class LMStepGraph(GraphedStep):
    """One batch shape's ``lm_step`` (``decode/window.py::GraphedStep``:
    replayed from a CUDA graph on one CUDA device, else run eagerly), with
    the static buffers it reads and writes: the step's tokens, positions
    and cache slot (one upload a step), the K/V cache (the prefill writes
    it in place), the routing counts, the logits, and with
    ``record_routes`` the chosen sets by position (``routes``, the
    prefill's too)."""

    def __init__(self, cfg: unimoe.UniMoEConfig, batch: int, capacity: int,
                 dtype, device, record_routes: bool = False):
        super().__init__(2 * batch + 1, device, batch)
        self.cache = unimoe.init_cache(cfg, batch, capacity, dtype,
                                       device=device)
        self.counts = torch.zeros(4, dtype=torch.int32, device=device)
        self.routes = torch.zeros(
            (capacity, cfg.n_layer, batch, cfg.n_choices), dtype=torch.bool,
            device=device) if record_routes else None

    def _run(self, params, cfg) -> torch.Tensor:
        B = self.batch
        return unimoe.lm_step(params, cfg, self._inp[:B],
                              self._inp[B:2 * B], self.cache,
                              self._inp[2 * B:], counts=self.counts,
                              routes=self.routes)

    def _warm(self, params, cfg) -> None:
        snap = self.counts.clone()
        self._run(params, cfg)
        self.counts.copy_(snap)          # the replay counts the step

    def step(self, params, cfg, tokens: np.ndarray, position: int
             ) -> torch.Tensor:
        """One LM step of every row at ``position`` (also the cache slot),
        ``run``; returns the logits (B, V).  The caller synchronises on the
        step's outputs before the next call (the loop's transfer does),
        which writes the upload buffer again."""
        B = self.batch
        self._host_np[:B] = tokens
        self._host_np[B:2 * B] = position
        self._host_np[2 * B] = position
        return self.run(lambda: self._run(params, cfg),
                        lambda: self._warm(params, cfg))


class UniMoEContext:
    """The speech path of a ``UniMoEConfig`` model on one device: its
    weights (used in place), the mel front end, the prompt around the
    audio tokens, and the token loop's step of one batch shape.
    ``record_routes``: keep every chosen set of the last batch on the
    device (``last_routes``), for a check; off, the step writes none."""

    family = "unimoe"

    def __init__(self, config: unimoe.UniMoEConfig, params, *, device,
                 mel_filters, prompt_head: Sequence[int],
                 prompt_tail: Sequence[int], record_routes: bool = False):
        self.config, self.params = config, params
        self.device = torch.device(device)
        self.mel = MelFrontend(mel_filters, self.device)
        self.prompt_head = [int(t) for t in prompt_head]
        self.prompt_tail = [int(t) for t in prompt_tail]
        self.timings = Timings()
        self.record_routes = bool(record_routes)
        self._routes_of = None           # (graph, positions) of last batch
        self._steps = StepCache()
        self.suppress = torch.zeros(config.n_vocab, dtype=torch.bool,
                                    device=self.device)

    @property
    def last_routes(self) -> Optional[torch.Tensor]:
        """The last batch's chosen sets, (positions, layers, rows, E + N)
        bool on the device, with ``record_routes``: the prompt's and each
        step's input token's.  A view of the step graph's buffer, which the
        next batch writes again; None without ``record_routes``."""
        if self._routes_of is None:
            return None
        g, n = self._routes_of
        return g.routes[:n]

    @property
    def prompt_len(self) -> int:
        return (len(self.prompt_head) + self.config.audio_tokens
                + len(self.prompt_tail))

    def graph(self, batch: int, capacity: int) -> LMStepGraph:
        """The step (and K/V cache) of one batch shape (``StepCache``)."""
        return self._steps.get((batch, capacity), lambda: LMStepGraph(
            self.config, batch, capacity,
            unimoe.compute_dtype_of(self.params), self.device,
            self.record_routes))

    # ---------------------------------------------------------- a batch
    def rows(self, clips: Sequence[np.ndarray]):
        """Every clip cut into chunks of ``audio_frames`` frames of audio
        (20 s): [(clip, start sample, pcm)]."""
        n = self.config.audio_frames * 2 * 160
        out = []
        for c, clip in enumerate(clips):
            clip = np.asarray(clip, np.float32)
            for s in range(0, max(len(clip), 1), n):
                out.append((c, s, clip[s:s + n]))
        return out

    def transcribe_batch(self, clips: Sequence[np.ndarray],
                         tparams: TranscribeParams) -> List[List[Segment]]:
        """Segments of every clip, in order: one a chunk, greedy, the
        tokens' ids and log-probabilities (no text: the repository holds
        no tokenizer of the LM)."""
        if not clips:
            return []
        cfg, params, dev = self.config, self.params, self.device
        rows = self.rows(clips)
        B = len(rows)
        with tracer.span("gwt.batch", clips=len(clips)):
            t0 = time.perf_counter()
            with tracer.span("gwt.mel", device=dev, clips=B) as sp:
                mel, _ = self.mel.device_batch([r[2] for r in rows],
                                               span=sp)
            t1 = time.perf_counter()
            self.timings.t_mel_us += int((t1 - t0) * 1e6)
            with tracer.span("gwt.encode", device=dev, rows=B):
                enc = encoder_forward(
                    params, cfg.audio,
                    mel[:, :, :WINDOW_FRAMES].transpose(1, 2))
            with tracer.span("gwt.connector", device=dev, rows=B):
                audio = unimoe.connector(params, cfg, enc)
            del enc, mel
            self.timings.t_encode_us += int((time.perf_counter() - t1) * 1e6)
            self.timings.n_encode += 1
            t2 = time.perf_counter()
            tokens, plogs = self.decode(audio, int(tparams.max_tokens))
            self.timings.t_decode_us += int((time.perf_counter() - t2)
                                            * 1e6)
            out: List[List[Segment]] = [[] for _ in clips]
            for j, (c, s, pcm) in enumerate(rows):
                toks = [TokenData(id=int(t), tid=0, p=float(np.exp(lp)),
                                  plog=float(lp), pt=0.0, ptsum=0.0)
                        for t, lp in zip(tokens[j], plogs[j])]
                out[c].append(Segment(
                    t0=s // 160, t1=(s + len(pcm)) // 160,
                    text="", tokens=toks))
        return out

    def decode(self, audio: torch.Tensor, max_tokens: int):
        """Prefill then greedy steps for audio tokens (B, 200, S) f32:
        each row's tokens before end-of-text (at most ``max_tokens`` + 1)
        and their log-probabilities."""
        cfg, params, dev = self.config, self.params, self.device
        B = audio.shape[0]
        P = self.prompt_len
        n_max = max_tokens + 1
        g = self.graph(B, round_cache_len(P + n_max))
        head = torch.tensor(self.prompt_head, device=dev).expand(B, -1)
        tail = torch.tensor(self.prompt_tail, device=dev).expand(B, -1)
        with tracer.span("gwt.prefill", device=dev, rows=B, tokens=B * P):
            x = unimoe.embed_prompt(params, head, audio, tail)
            rec = [] if g.routes is not None else None
            logits = unimoe.prefill(params, cfg, x, g.cache, routing=rec)
            if rec is not None:
                g.routes[:P] = torch.stack(rec).view(
                    cfg.n_layer, B, P, cfg.n_choices).permute(2, 0, 1, 3)
            del x, rec
        g.counts.zero_()
        g.load()
        state = torch.tensor([[0, -1, -1, 0, 0, 0, 1]] * B, dtype=torch.int32,
                             device=dev)
        tokens = np.zeros((B, n_max), np.int32)
        plogs = np.zeros((B, n_max), np.float32)
        done = np.zeros(B, bool)
        n_done = np.full(B, n_max)
        counts = np.zeros(4, np.int64)
        with tracer.span("gwt.token_loop") as sp:
            for i in range(n_max):
                with tracer.span("gwt.step.sample"):
                    out = fused_filter_sample(
                        logits, self.suppress, state, temperature=0.0,
                        seed=0, eot=cfg.token_eot, beg=cfg.n_vocab,
                        space_id=-1, max_initial_tid=0,
                        suppress_blank=False, no_timestamps=True)
                    packed = torch.cat([out.token.view(torch.float32),
                                        out.plog,
                                        g.counts.view(torch.float32)]
                                       ).cpu().numpy()
                ids = packed[:B].view(np.int32)
                tokens[:, i] = ids
                plogs[:, i] = packed[B:2 * B]
                counts = packed[2 * B:].view(np.int32).astype(np.int64)
                ended = ~done & (ids == cfg.token_eot)
                n_done[ended] = i
                done |= ended
                if i == n_max - 1 or done.all():
                    break
                with tracer.span("gwt.step.forward"):
                    logits = g.step(params, cfg, ids, P + i)
            steps = i + 1
            sp.set(steps=steps, graph_steps=g.graph_steps(),
                   token_layers=int(counts[0]), routed_pairs=int(counts[1]),
                   null_picks=int(counts[2]), experts_hit=int(counts[3]))
        self.timings.n_decode += steps
        self._routes_of = ((g, P + steps - 1) if g.routes is not None
                           else None)
        keep = [tokens[b, :n_done[b]].tolist() for b in range(B)]
        lps = [plogs[b, :n_done[b]].tolist() for b in range(B)]
        return keep, lps
