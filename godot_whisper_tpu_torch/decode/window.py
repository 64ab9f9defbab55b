"""Autoregressive decode of one 30 s window: greedy / temperature sampling
and beam search.

Port of the JAX package's ``decode/window.py``.  The JAX package runs the
whole loop as one ``lax.while_loop``; here it is a Python loop over device
tensors:

- each step runs the fused filter + sampler kernel (K5) on the raw logits,
  or, in beam search, the fused filter + top-K kernel (K6); copies its
  per-row outputs to the host in ONE transfer (the step's only
  synchronisation, which also tests "all rows done"); advances the beam
  merge and the decoder state machine in numpy; and runs ``decoder_step``
  for the next logits;
- the beam merge (``_merge_beam``, whisper.cpp:5327-5419) is the JAX
  package's, candidate for candidate: per-group scores, a stable
  descending sort, the equal-score dedupe from step 0, dead rows keeping
  themselves.  The cache follows the merge without moving a byte in
  split-cache mode (``use_split_cache``: the prompt K/V stored once per
  group, the live K/V per beam read through a permuted (B, NL) row map by
  K7), or through the bounded reorder K8 into a second cache that the loop
  swaps with the first (configurations too wide for K7);
- the state machine is the JAX package's step for step: completed /
  failed / has_ts / seek_delta / result_len, the timestamp window advance
  and "back in time" failure, EOT / max_tokens / end-of-audio completion
  with the result_len == 0 rescue, the weightless-stub fast path and the
  final-step repetition failure (whisper.cpp:5421-5507);
- the JAX loop's unconditional extra decoder step after the last token
  (an XLA workaround) is skipped;
- greedy and sampling windows (``run_greedy_loop``) step one object of
  the batch's shape (``StepGraph``) that owns the step's buffers and
  makes one upload a step; on one CUDA device it replays the decoder step
  as one CUDA graph (the same kernels, without ~330 launches from the
  host a step), elsewhere it runs the same step eagerly.  Beam search
  (``run_beam_loop``) steps eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..models.config import WhisperConfig
from ..models.model import (KVCache, cross_kv, decoder_dense, decoder_step,
                            init_kv_cache, param_compute_dtype,
                            quantize_cross_kv, round_cache_len)
from ..ops import kernels as K
from ..ops.cross_attention import w8a8_default
from ..ops.filter_sample import fused_filter_sample, fused_filter_topk
from ..ops.kv_reorder import reorder_kv_live
from ..parallel.collectives import tp_size
from ..runtime.trace import tracer
from .filters import FilterContext

SEEK_DELTA_FULL = 3000  # 100 * WHISPER_CHUNK_SIZE (whisper.cpp:5222)


class WindowResult(NamedTuple):
    """Host-side (numpy) state of one window decode after its loop; the
    JAX package's LoopState minus the device-only fields."""
    tokens: np.ndarray
    tok_p: np.ndarray
    tok_plog: np.ndarray
    tok_pt: np.ndarray
    tok_ptsum: np.ndarray
    tok_tid: np.ndarray
    completed: np.ndarray
    failed: np.ndarray
    has_ts: np.ndarray
    seek_delta: np.ndarray
    result_len: np.ndarray
    sum_logprobs_all: np.ndarray
    n_steps: int
    graph_steps: int = 0    # n_steps when the decoder steps ran by replay


@dataclasses.dataclass(frozen=True)
class WindowStatics:
    """Static configuration of one window decode."""
    config: WhisperConfig
    batch: int
    n_max: int
    prompt_pad: int
    greedy_argmax: bool     # temperature == 0: argmax, else Gumbel sampling
    suppress_blank: bool
    no_timestamps: bool
    single_segment: bool
    max_tokens: int
    test_mode: bool         # weightless stub model fast path
    # consecutive groups of kv_group rows (the decoders of one stream)
    # share one cross-KV row
    kv_group: int = 1
    strategy: str = "greedy"  # "greedy" | "beam"
    beam_size: int = 1        # beams per group (beam strategy)
    # the mesh's tp group (models/model.py), None on one device
    tp: Any = None


def use_split_cache(statics: WindowStatics) -> bool:
    """Beam decode keeps the prompt K/V once per group and the live K/V per
    beam (K7) when beam_size * n_text_head <= 128, as the JAX package does
    (its packed-lane kernel needs it); wider configurations keep one merged
    cache per beam, reordered by K8 at every merge.  The rule counts the
    model's heads, not a tp rank's, so a tp run takes the route of tp 1."""
    return (statics.strategy == "beam"
            and statics.beam_size * statics.config.n_text_head <= 128)


class StepCache:
    """A token loop's step for one key (the batch shape) at a time, made
    anew when the key changes, the old one dropped first so that its
    buffers go before the new ones are made (``StepGraphs``,
    ``decode/omni.py::UniMoEContext``)."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.key = self.step = None

    def get(self, key, make):
        """The step of ``key``, made by ``make()`` where the key is new."""
        if key != self.key:
            self.clear()
            self.key, self.step = key, make()
        return self.step


class GraphedStep:
    """A token loop's step with the static buffers it reads: an int32
    upload buffer (pinned on the host for a CUDA device, with its device
    twin ``_inp`` that the step reads), and ``run``, which uploads it and
    runs the step: captured as one CUDA graph on first use and replayed
    where it can (``replays_on``), else eagerly.  A capture runs the step
    once eagerly on a side stream first (the split-cache tickets, the
    kernels' libraries and cuBLAS's workspace exist after it), then
    captures it there; every replay adds the step's launches to the
    kernel wrappers' counters.  Subclasses keep the static buffers the
    step reads and writes."""

    def __init__(self, n_upload: int, device, batch: int, tp=None):
        self.device, self.batch = device, batch
        self._graphed = self.replays_on(device, tp)
        self._host = torch.zeros(n_upload, dtype=torch.int32)
        if torch.device(device).type == "cuda":
            self._host = self._host.pin_memory()
        self._host_np = self._host.numpy()
        self._inp = torch.zeros(n_upload, dtype=torch.int32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self._launches: Optional[K.CapturedLaunches] = None
        self.replays = 0

    @staticmethod
    def replays_on(device, tp) -> bool:
        """On one CUDA device: NCCL collectives (``tp``) under capture have
        never run across cards."""
        return torch.device(device).type == "cuda" and tp is None

    def load(self) -> None:
        """A loop starts: ``replays`` counts its steps from here."""
        self.replays = 0

    def graph_steps(self) -> int:
        """The loop's steps on the graph: the forwards it replayed, and
        with them the first (the prompt pass's logits)."""
        return self.replays + int(self._graphed)

    def upload(self) -> None:
        """The host buffer to the device, in stream order (the loop syncs
        on K5's outputs before the host writes the buffer again)."""
        self._inp.copy_(self._host, non_blocking=True)

    def run(self, step, warm=None) -> torch.Tensor:
        """Upload, then ``step``: replayed where the step replays (captured
        on first use, after ``warm``, by default ``step``, once eagerly),
        else run eagerly; returns its output."""
        self.upload()
        if not self._graphed:
            return step()
        with torch.cuda.device(self.device):
            if self._launches is None:       # first use
                self._capture(step, warm or step)
            self.graph.replay()
        self._launches.add()
        self.replays += 1
        return self.logits

    def _capture(self, step, warm) -> None:
        with tracer.span("gwt.step.capture", rows=self.batch):
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                warm()               # writes the step's K/V, as the replay
            graph = torch.cuda.CUDAGraph()
            with K.CapturedLaunches() as launches, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                self.logits = step()
            cur.wait_stream(side)
            self.graph, self._launches = graph, launches


class StepGraph(GraphedStep):
    """One batch shape's ``decoder_step`` (``GraphedStep``) with the static
    buffers it reads and writes: the step's token ids, positions and cache
    slot (beside them the sampler's state, so a step makes one upload),
    the prompt lengths ``lo``, the self-KV cache (the prompt pass writes
    it in place), and the cross-KV (``StepGraphs``' buffer).  The step
    returns the logits (B, V) f32."""

    def __init__(self, statics: WindowStatics, device: torch.device,
                 cdtype: torch.dtype, xkv):
        B = statics.batch
        # the step's upload: tokens (B), positions (B), slot (1), padding
        # to 16 bytes, the sampler's state (B, 7)
        self._state_at = -(-(2 * B + 1) // 4) * 4
        super().__init__(self._state_at + 7 * B, device, B, statics.tp)
        self.kv_group, self.prompt_pad = statics.kv_group, statics.prompt_pad
        self.tp = statics.tp
        self.kv = init_kv_cache(statics.config, B,
                                statics.prompt_pad + statics.n_max,
                                dtype=cdtype, device=device, tp=statics.tp)
        self.xkv = xkv
        self.lo = torch.zeros((B,), dtype=torch.int32, device=device)
        self.state = self._inp[self._state_at:].view(B, 7)

    def load(self, n_prompt: np.ndarray) -> None:
        """A window's prompt lengths into ``lo``; its loop starts."""
        self.lo.copy_(torch.from_numpy(np.array(n_prompt, np.int32)))
        super().load()

    def set_state(self, state: np.ndarray) -> torch.Tensor:
        """The sampler's state (B, 7) for the next upload; returns its
        device view."""
        self._host_np[self._state_at:] = state.reshape(-1)
        return self.state

    def step(self, params, config: WhisperConfig, tokens: np.ndarray,
             positions: np.ndarray, slot: int) -> torch.Tensor:
        """One decoder step (``run``), reading ``slot`` from the upload
        where it replays; returns the logits (B, V) f32."""
        B = self.batch
        self._host_np[:B] = tokens
        self._host_np[B:2 * B] = positions
        self._host_np[2 * B] = slot
        return self.run(lambda: decoder_step(
            params, config, self._inp[:B], self._inp[B:2 * B], self.kv,
            self.xkv, lo=self.lo,
            slot=self._inp[2 * B:2 * B + 1] if self._graphed else slot,
            split=self.prompt_pad, kv_group=self.kv_group, tp=self.tp)[0])


class StepGraphs:
    """A pipeline's token-loop steps: the cross-KV buffer that its windows'
    ``cross_kv`` writes, and the greedy / sampling step (``StepGraph``)
    that reads it, for one batch shape at a time (``StepCache``).  A
    cross-KV of another shape or other weights drops the step with the
    buffer.  Both stay allocated between windows.  One window uses them at
    a time, as the pipeline runs one ``full`` at a time."""

    def __init__(self):
        self._steps = StepCache()
        self.clear()

    def clear(self) -> None:
        """Drop the buffer and the step."""
        self._steps.clear()
        self._params = self._xkv_key = self._xkv = None

    def cross_kv(self, params, config: WhisperConfig, enc: torch.Tensor,
                 quant: bool, tp=None):
        """The cross-KV of ``enc`` (int8 with ``quant``; this rank's heads
        under ``tp``), written into the buffer that the step reads:
        ``models/model.py::cross_kv``, then ``quantize_cross_kv``.  It
        holds until the next call."""
        key = (enc.device, enc.shape[0], enc.shape[1], quant, tp_size(tp))
        if params is not self._params or key != self._xkv_key:
            self.clear()
            self._params, self._xkv_key = params, key
        out = self._xkv
        xkv = cross_kv(params, config, enc, tp=tp,
                       out=None if quant else out)
        if quant:
            xkv = quantize_cross_kv(xkv, config.n_text_head // tp_size(tp),
                                    out=out)
        self._xkv = xkv
        return xkv

    def get(self, params, statics: WindowStatics, xkv) -> StepGraph:
        """The greedy / sampling step of this window's shape, reading
        ``xkv``: one that ``cross_kv`` did not make becomes the buffer (by
        reference), dropping the old one with its step."""
        if (params is not self._params or self._xkv is None
                or xkv[0] is not self._xkv[0]):
            self.clear()
            self._params, self._xkv = params, xkv
        key = (statics.batch, statics.kv_group, statics.prompt_pad,
               statics.n_max, statics.tp, w8a8_default())
        return self._steps.get(key, lambda: StepGraph(
            statics, xkv.device, param_compute_dtype(params), self._xkv))


def prompt_pass_grouped(params, config: WhisperConfig, prompt: torch.Tensor,
                        n_prompt: np.ndarray, xkv, n_dec: int,
                        n_max: Optional[int] = None, repeat_kv: bool = True,
                        tp=None, out: Optional[KVCache] = None):
    """Grouped prompt pass: G streams (``prompt`` (G, P), each its own
    length; ``xkv`` a CrossKV or an int8 QuantCrossKV) decode their prompts
    ONCE, then the logits and self-KV repeat to each stream's n_dec decoder
    rows (kv_cache_seq_cp 0 -> j per stream, whisper.cpp:5277).  The cache
    holds P + n_max slots; the padded prompt capacity P is the decode
    loop's ``split``.  With ``repeat_kv=False`` the self-KV keeps its G
    rows: the split-cache beam loop stores the prompt once per group.
    ``out``: a cache of the repeated shape, written in place (a
    ``StepGraph``'s); None writes a new one.  Returns (last_logits (B, V)
    f32, kv)."""
    G, P = prompt.shape
    dev = prompt.device
    kv = init_kv_cache(config, G,
                       cache_len=P + (n_max if n_max is not None
                                      else config.n_text_ctx // 2 - 4),
                       dtype=param_compute_dtype(params), device=dev, tp=tp,
                       out=out if n_dec == 1 else None)
    positions = torch.arange(P, dtype=torch.int32, device=dev).expand(G, P)
    n_prompt_t = torch.as_tensor(np.asarray(n_prompt, np.int64).reshape(G),
                                 device=dev)
    logits, kv = decoder_dense(params, config, prompt, positions, kv, xkv,
                               n_valid=n_prompt_t,
                               logit_rows=n_prompt_t - 1, tp=tp)
    last = logits[:, 0]
    if n_dec == 1:
        return last, kv
    last = last.repeat_interleave(n_dec, dim=0)
    if not repeat_kv:
        return last, kv
    l, g, c, w = kv.k.shape
    if out is None:
        out = KVCache(k=kv.k.new_empty((l, g * n_dec, c, w)),
                      v=kv.v.new_empty((l, g * n_dec, c, w)))
    for src, dst in zip(kv, out):
        dst.view(l, g, n_dec, c, w).copy_(src[:, :, None])
    return last, out


def _attempt_seed(rng_seed: int, step: int) -> int:
    """Per-step seed of the sampler's counter hash (rows are hashed in)."""
    return (1000003 * step + 7919 * rng_seed) & 0xFFFFFFFF


class BeamMerge(NamedTuple):
    """One beam merge: the source row of every row and the chosen
    candidate's token data, all (B,)."""
    src: np.ndarray
    ids: np.ndarray
    p: np.ndarray
    plog: np.ndarray
    pt: np.ndarray
    ptsum: np.ndarray
    tid: np.ndarray
    score: np.ndarray     # new sum of log-probs (the old sum on dead rows)


def _merge_beam(cand_plog: np.ndarray, cand_ids: np.ndarray,
                cand_p: np.ndarray, pt0: np.ndarray, ptsum0: np.ndarray,
                tid0: np.ndarray, sum_lp: np.ndarray, live: np.ndarray,
                beg: int) -> BeamMerge:
    """The JAX package's grouped beam merge (whisper.cpp:5327-5419) in
    numpy.  The batch is G groups of K = beam_size rows; ``cand_*`` are each
    row's (B, K) top-K expansion candidates, ``pt0/ptsum0/tid0`` its
    pre-merge timestamp statistics, ``sum_lp`` its sum of log-probs.

    Per group: the K*K candidate scores (sum + candidate log-prob, -inf on
    dead rows) sorted descending by a STABLE sort; the equal-score dedupe
    active from step 0 (the JAX package's choice for its deterministic
    top-K expansion: at step 0 every beam holds the same distribution, and
    the dedupe makes the first expansion the top-K distinct tokens); the
    j-th live row takes the first candidate of score run ``j % n_runs``;
    dead rows keep themselves."""
    B, K = cand_plog.shape
    G, n = B // K, K * K
    rows = np.arange(B)
    scores = np.where(live[:, None], sum_lp[:, None] + cand_plog,
                      np.float32(-np.inf)).astype(np.float32)
    flat = scores.reshape(G, n)
    order = np.argsort(-flat, axis=1, kind="stable")
    ranked = np.take_along_axis(flat, order, axis=1)
    starts = np.concatenate([np.ones((G, 1), bool),
                             ranked[:, 1:] != ranked[:, :-1]], axis=1)
    run = np.cumsum(starts, axis=1) - 1                     # (G, n)
    n_runs = np.maximum(starts.sum(axis=1), 1)              # (G,)
    # first sorted position of each run of equal scores, per group
    first_pos = np.full((G, n), n - 1, np.int64)
    np.minimum.at(first_pos, (np.arange(G)[:, None], run),
                  np.broadcast_to(np.arange(n), (G, n)))
    live_g = live.reshape(G, K)
    slot_rank = np.cumsum(live_g, axis=1) - 1
    target = np.where(live_g, slot_rank % n_runs[:, None], 0)
    chosen = np.take_along_axis(
        order, np.take_along_axis(first_pos, target, axis=1), axis=1)

    def pick(a):
        return np.take_along_axis(a.reshape(G, n), chosen, axis=1).reshape(B)

    src = np.where(live, (chosen // K + np.arange(G)[:, None] * K)
                   .reshape(B), rows)
    ids = np.where(live, pick(cand_ids), 0).astype(np.int32)
    plog = np.where(live, pick(cand_plog), np.float32(0)).astype(np.float32)
    # the chosen candidate's probability, from its source row
    p = pick(cand_p)
    pt, ptsum, tid = pt0[src], ptsum0[src], tid0[src]
    is_ts = ids >= beg
    tid = np.where(is_ts, ids, tid).astype(np.int32)
    pt = np.where(is_ts, p, pt).astype(np.float32)
    score = np.where(live, pick(flat), sum_lp).astype(np.float32)
    return BeamMerge(src=src, ids=ids, p=p, plog=plog, pt=pt, ptsum=ptsum,
                     tid=tid, score=score)


def permute_rowmap(rowmap: np.ndarray, src: np.ndarray, i: int,
                   beam_size: int) -> np.ndarray:
    """The split cache's zero-copy merge: every beam takes its source's row
    map, and live slot i (written next) maps to the beam's own row."""
    out = rowmap[src]
    out[:, i] = np.arange(len(src)) % beam_size
    return out


class _Rows:
    """The host state of a window's rows (``WindowResult``'s arrays) and
    the decoder state machine that both loops run.  ``n_prompt``, ``seek``
    and ``seek_end`` are per row (or scalars)."""

    def __init__(self, statics: WindowStatics, fctx: FilterContext,
                 n_prompt, seek, seek_end):
        B, N = statics.batch, statics.n_max
        self.statics, self.fctx = statics, fctx
        self.n_prompt, self.seek, self.seek_end = (
            np.broadcast_to(np.asarray(v, np.int32), (B,))
            for v in (n_prompt, seek, seek_end))
        self.tokens = np.zeros((B, N), np.int32)
        self.tok_p, self.tok_plog, self.tok_pt, self.tok_ptsum = (
            np.zeros((B, N), np.float32) for _ in range(4))
        self.tok_tid = np.zeros((B, N), np.int32)
        self.completed, self.failed, self.has_ts = (
            np.zeros(B, bool) for _ in range(3))
        self.seek_delta = np.full(B, SEEK_DELTA_FULL, np.int32)
        self.result_len = np.zeros(B, np.int32)
        self.sum_logprobs_all = np.zeros(B, np.float32)

    def state(self, i: int) -> np.ndarray:
        """Step i's sampler state (B, 7) int32: first-step flag, the last
        two tokens, the step, has_ts, seek_delta, the argmax flag."""
        B = len(self.seek)
        none = np.full(B, -1, np.int32)
        return np.stack([
            np.full(B, int(i == 0)), self.tokens[:, i - 1] if i > 0 else none,
            self.tokens[:, i - 2] if i > 1 else none, np.full(B, i),
            self.has_ts, self.seek_delta,
            np.full(B, int(self.statics.greedy_argmax))],
            axis=1).astype(np.int32)

    def filter_args(self, temperature: float) -> dict:
        """The static arguments of K5 and K6."""
        fctx, st = self.fctx, self.statics
        return dict(temperature=temperature, eot=fctx.token_eot,
                    beg=fctx.token_beg, space_id=fctx.space_id,
                    max_initial_tid=fctx.max_initial_tid,
                    suppress_blank=st.suppress_blank,
                    no_timestamps=st.no_timestamps)

    def write(self, i: int, live: np.ndarray, ids, p, plog, pt, ptsum, tid,
              new_sum) -> None:
        """Step i's token data of the live rows, and their new sum of
        log-probabilities."""
        self.tokens[live, i] = ids[live]
        self.tok_p[live, i] = p[live]
        self.tok_plog[live, i] = plog[live]
        self.tok_pt[live, i] = pt[live]
        self.tok_ptsum[live, i] = ptsum[live]
        self.tok_tid[live, i] = tid[live]
        self.sum_logprobs_all = np.where(
            live, new_sum, self.sum_logprobs_all).astype(np.float32)

    def follow(self, src: np.ndarray) -> None:
        """The candidate-carried state follows the source beams
        (whisper.cpp:5332, 5397-5400); completed / failed stay."""
        self.tokens, self.tok_p = self.tokens[src], self.tok_p[src]
        self.tok_plog, self.tok_pt = self.tok_plog[src], self.tok_pt[src]
        self.tok_ptsum, self.tok_tid = self.tok_ptsum[src], self.tok_tid[src]
        self.has_ts, self.seek_delta = self.has_ts[src], self.seek_delta[src]
        self.result_len = self.result_len[src]

    def advance(self, i: int, live: np.ndarray, ids: np.ndarray) -> bool:
        """The decoder state machine after step i's tokens ``ids``
        (whisper.cpp:5421-5507); returns whether the loop is finished."""
        st, beg = self.statics, self.fctx.token_beg
        is_ts_tok = ids > beg
        sd_new = (2 * (ids - beg)).astype(np.int32)
        back_in_time = (self.has_ts & (self.seek_delta > sd_new)
                        & (self.result_len < i))
        fail_ts = live & is_ts_tok & back_in_time
        take_ts = live & is_ts_tok & ~back_in_time
        seek_delta = np.where(take_ts, sd_new, self.seek_delta)
        result_len = np.where(take_ts, i + 1,
                              self.result_len).astype(np.int32)
        self.has_ts = has_ts = self.has_ts | take_ts
        failed = self.failed | fail_ts

        alive = live & ~fail_ts
        end_of_text = ids == self.fctx.token_eot
        max_tok = st.max_tokens > 0 and i >= st.max_tokens
        rescue = self.seek + seek_delta + 100 >= self.seek_end
        wants_end = alive & (end_of_text | max_tok | (has_ts & rescue))

        zero_res = result_len == 0
        fail_zero = wants_end & zero_res & ~rescue
        result_len = np.where(wants_end & zero_res & rescue, i + 1,
                              result_len).astype(np.int32)
        failed = failed | fail_zero
        complete_now = wants_end & ~(zero_res & ~rescue)
        if st.single_segment:
            result_len = np.where(complete_now, i + 1,
                                  result_len).astype(np.int32)
            seek_delta = np.where(complete_now, SEEK_DELTA_FULL, seek_delta)
        completed = self.completed | complete_now

        if st.test_mode:
            # stub checkpoint: complete immediately (whisper.cpp:5492-5497)
            still = alive & ~complete_now & ~fail_zero
            seek_delta = np.where(still, SEEK_DELTA_FULL, seek_delta)
            completed = completed | still

        # repetition-loop failure on the final step (whisper.cpp:5500-5506)
        last = i == st.n_max - 1
        if last:
            rep = (result_len == 0) | (seek_delta < SEEK_DELTA_FULL // 2)
            failed = failed | (alive & ~complete_now & rep)
        self.seek_delta = seek_delta.astype(np.int32)
        self.result_len, self.failed, self.completed = (result_len, failed,
                                                        completed)
        return last or bool(np.all(completed | failed))

    def result(self, n_steps: int, graph_steps: int) -> WindowResult:
        return WindowResult(
            self.tokens, self.tok_p, self.tok_plog, self.tok_pt,
            self.tok_ptsum, self.tok_tid, self.completed, self.failed,
            self.has_ts, self.seek_delta, self.result_len,
            self.sum_logprobs_all, n_steps, graph_steps)


def run_decode_loop(params, config: WhisperConfig, fctx: FilterContext,
                    statics: WindowStatics, graphs: StepGraphs, xkv,
                    prompt: torch.Tensor, n_prompt: np.ndarray,
                    temperature: float, seek, seek_end, rng_seed: int,
                    **span) -> WindowResult:
    """A window's prompt pass and token loop: ``prompt`` (G, P) holds
    ``n_prompt`` (G,) tokens a stream, each decoded by ``statics.kv_group``
    rows; ``seek`` and ``seek_end`` per row (or scalars).  Greedy and
    sampling write the prompt into ``graphs``' step and step it
    (``run_greedy_loop``); beam search takes a new cache
    (``run_beam_loop``).  ``span``: more fields of both spans."""
    beam = statics.strategy == "beam"
    step = None if beam else graphs.get(params, statics, xkv)
    with tracer.span("gwt.prompt", rows=prompt.shape[0], **span):
        last, kv = prompt_pass_grouped(
            params, config, prompt, n_prompt, xkv, statics.kv_group,
            n_max=statics.n_max, repeat_kv=not use_split_cache(statics),
            tp=statics.tp, out=None if beam else step.kv)
    with tracer.span("gwt.token_loop", **span) as sp:
        rows = _Rows(statics, fctx, np.repeat(n_prompt, statics.kv_group),
                     seek, seek_end)
        res = (run_beam_loop(params, config, rows, xkv, kv, last, temperature)
               if beam else run_greedy_loop(params, config, rows, step, last,
                                            temperature, rng_seed))
        sp.set(steps=res.n_steps, graph_steps=res.graph_steps)
    return res


def run_greedy_loop(params, config: WhisperConfig, rows: _Rows,
                    step: StepGraph, last_logits: torch.Tensor,
                    temperature: float, rng_seed: int) -> WindowResult:
    """Greedy / sampling rows: K5 samples each row, the state machine
    advances, and ``step`` (whose cache the prompt pass wrote) runs the
    decoder step, replayed or eagerly (``GraphedStep.run``)."""
    statics, fctx = rows.statics, rows.fctx
    step.load(rows.n_prompt)
    filt = rows.filter_args(temperature)
    logits = last_logits.float().contiguous()
    with tracer.span("gwt.step.state"):
        state = step.set_state(rows.state(0))
        step.upload()
    for i in range(statics.n_max):
        live = ~(rows.completed | rows.failed)
        # ONE device -> host transfer of the step's outputs per step (int32
        # columns ride bit-exactly as float32 views)
        with tracer.span("gwt.step.sample"):
            out = fused_filter_sample(
                logits, fctx.static_suppress, state,
                seed=_attempt_seed(rng_seed, i), **filt)
            packed = torch.stack([out.token.view(torch.float32), out.p,
                                  out.plog, out.pt, out.ptsum,
                                  out.tid.view(torch.float32)]).cpu().numpy()
        with tracer.span("gwt.step.state"):
            ids, tid = packed[0].view(np.int32), packed[5].view(np.int32)
            rows.write(i, live, ids, *packed[1:5], tid,
                       rows.sum_logprobs_all + packed[2])
            finished = rows.advance(i, live, ids)
            if not finished:
                state = step.set_state(rows.state(i + 1))
        if finished:
            break
        # ---- next-step logits; the cache slot is the batch-uniform
        # prompt_pad + i, the true position n_prompt + i drives the
        # positional embedding
        with tracer.span("gwt.step.forward"):
            logits = step.step(params, config, rows.tokens[:, i],
                               rows.n_prompt + i, statics.prompt_pad + i)
    return rows.result(i + 1, step.graph_steps())


def run_beam_loop(params, config: WhisperConfig, rows: _Rows, xkv,
                  kv: KVCache, last_logits: torch.Tensor,
                  temperature: float) -> WindowResult:
    """Beam search, eagerly: K6's top-K candidates, the beam merge, the
    state machine, the decoder step.  ``kv``: the prompt's cache, one row
    a group with the split cache, else one a beam."""
    statics, fctx = rows.statics, rows.fctx
    B, N_MAX, KB = statics.batch, statics.n_max, statics.beam_size
    dev = last_logits.device
    lo = torch.as_tensor(rows.n_prompt.copy(), device=dev)
    split = use_split_cache(statics)
    kv_prompt = rowmap = kv_alt = None
    if split:
        # the prompt K/V once per group; the live K/V per beam in a fresh
        # cache written at slot i; every beam owns its own row at first
        cp, nl = round_cache_len(statics.prompt_pad), round_cache_len(N_MAX)
        kv_prompt = KVCache(*(t[:, :, :cp].contiguous() for t in kv))
        kv = KVCache(*(t.new_zeros((t.shape[0], B, nl, t.shape[3]))
                       for t in kv))
        rowmap = np.tile((np.arange(B, dtype=np.int32) % KB)[:, None],
                         (1, nl))
    else:
        kv_alt = KVCache(*map(torch.empty_like, kv))

    filt = rows.filter_args(temperature)
    logits = last_logits.float().contiguous()
    with tracer.span("gwt.step.state"):
        state = torch.from_numpy(rows.state(0)).to(dev)
    for i in range(N_MAX):
        live = ~(rows.completed | rows.failed)
        # ONE device -> host transfer of the step's outputs per step
        with tracer.span("gwt.step.sample"):
            out = fused_filter_topk(logits, fctx.static_suppress, state,
                                    K=KB, **filt)
            packed = torch.cat(
                [out.plog, out.ids.view(torch.float32), out.p,
                 torch.stack([out.pt, out.ptsum,
                              out.tid.view(torch.float32)], dim=1)],
                dim=1).cpu().numpy()

        with tracer.span("gwt.step.state"):
            m = _merge_beam(
                packed[:, :KB], packed[:, KB:2 * KB].view(np.int32),
                packed[:, 2 * KB:3 * KB], packed[:, 3 * KB],
                packed[:, 3 * KB + 1],
                np.ascontiguousarray(packed[:, 3 * KB + 2]).view(np.int32),
                rows.sum_logprobs_all, live, fctx.token_beg)
            rows.follow(m.src)
            if split:
                rowmap = permute_rowmap(rowmap, m.src, i, KB)
            else:
                kv, kv_alt = (KVCache(*reorder_kv_live(
                    kv.k, kv.v,
                    torch.from_numpy(m.src.astype(np.int32)).to(dev),
                    statics.prompt_pad + i, out=kv_alt)), kv)
            rows.write(i, live, m.ids, m.p, m.plog, m.pt, m.ptsum, m.tid,
                       m.score)
            finished = rows.advance(i, live, m.ids)
            if not finished:
                state = torch.from_numpy(rows.state(i + 1)).to(dev)
        if finished:
            break
        # ---- next-step logits: live slot i in the split cache
        with tracer.span("gwt.step.forward"):
            logits, kv = decoder_step(
                params, config,
                torch.from_numpy(rows.tokens[:, i].copy()).to(dev),
                torch.from_numpy((rows.n_prompt + i).astype(np.int32)).to(dev),
                kv, xkv, lo=lo, slot=i if split else statics.prompt_pad + i,
                split=statics.prompt_pad, kv_group=statics.kv_group,
                kv_prompt=kv_prompt,
                rowmap=torch.from_numpy(rowmap).to(dev) if split else None,
                tp=statics.tp)
    return rows.result(i + 1, 0)


class WindowDecoder:
    """Decode of one window for ``n_decoders`` rows that share one prompt:
    greedy / sampling, or beam search (``strategy="beam"``, one group of
    ``beam_size`` beams)."""

    def __init__(self, config: WhisperConfig, fctx: FilterContext,
                 tp=None, graphs: Optional[StepGraphs] = None):
        self.config = config
        self.fctx = fctx
        self.tp = tp
        self.graphs = graphs if graphs is not None else StepGraphs()

    def decode(self, params, xkv, prompt_tokens: np.ndarray, *,
               n_decoders: int, temperature: float, seek: int, seek_end: int,
               suppress_blank: bool, no_timestamps: bool,
               single_segment: bool, max_tokens: int, test_mode: bool,
               seed: int = 0, strategy: str = "greedy",
               beam_size: int = 1) -> WindowResult:
        """``xkv`` is a CrossKV or an int8 QuantCrossKV (``StepGraphs``
        holds one that ``graphs.cross_kv`` did not make)."""
        config = self.config
        n_max = config.n_text_ctx // 2 - 4  # whisper.cpp:5288
        P = int(len(prompt_tokens))
        pad = 8  # prompt capacity bucketed as in the JAX package
        while pad < P:
            pad *= 2
        pad = min(pad, config.n_text_ctx // 2 + 8)
        if strategy == "beam" and n_decoders != beam_size:
            raise ValueError("beam search decodes one group: n_decoders "
                             "must equal beam_size")
        statics = WindowStatics(
            config=config, batch=n_decoders, n_max=n_max, prompt_pad=pad,
            greedy_argmax=strategy == "greedy" and temperature < 1e-6,
            suppress_blank=suppress_blank, no_timestamps=no_timestamps,
            single_segment=single_segment, max_tokens=max_tokens,
            test_mode=test_mode, kv_group=n_decoders, strategy=strategy,
            beam_size=beam_size, tp=self.tp)
        prompt = np.zeros((1, pad), np.int32)
        prompt[0, :P] = prompt_tokens
        return run_decode_loop(params, config, self.fctx, statics,
                               self.graphs, xkv,
                               torch.from_numpy(prompt).to(xkv.device),
                               np.asarray([P]), temperature, seek, seek_end,
                               seed)
