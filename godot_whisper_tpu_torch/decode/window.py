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
- on a CUDA device, outside beam search and tensor parallelism, the
  decoder step is one CUDA graph of the batch's shape (``StepGraph``),
  replayed every step after one upload of the step's tokens, positions,
  cache slot and sampler state: the same kernels in the same order,
  without ~330 launches from the host a step.
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
    # tests only: the merged-cache beam path (K8) at any width
    force_merged_cache: bool = False
    # the mesh's tp group (models/model.py), None on one device
    tp: Any = None


def use_split_cache(statics: WindowStatics) -> bool:
    """Beam decode keeps the prompt K/V once per group and the live K/V per
    beam (K7) when beam_size * n_text_head <= 128, as the JAX package does
    (its packed-lane kernel needs it); wider configurations keep one merged
    cache per beam, reordered by K8 at every merge.  The rule counts the
    model's heads, not a tp rank's, so a tp run takes the route of tp 1."""
    return (statics.strategy == "beam" and not statics.force_merged_cache
            and statics.beam_size * statics.config.n_text_head <= 128)


def _one_cuda_device(device, tp) -> bool:
    """Where a decoder step can replay a captured CUDA graph: tensors on a
    CUDA device (CPU tensors take the plain versions, eagerly), and one
    device (``tp`` None: NCCL collectives under capture have never run
    across cards)."""
    return torch.device(device).type == "cuda" and tp is None


def graph_eligible(statics: WindowStatics, device) -> bool:
    """Whether a window's decoder steps replay one captured CUDA graph,
    decided from what the loop sees: ``_one_cuda_device``, and not beam
    search (the split cache's row map, K7's input, and the merged cache's
    swap with its twin after K8 change every step)."""
    return (_one_cuda_device(device, statics.tp)
            and statics.strategy != "beam")


class GraphedStep:
    """The capture and replay of a token loop's step as one CUDA graph: an
    int32 upload buffer (pinned on the host, with its device twin ``_inp``
    that the step reads), and ``replay``, which uploads it, captures the
    step on first use and replays it.  A capture runs the step once
    eagerly on a side stream first (the split-cache tickets, the kernels'
    libraries and cuBLAS's workspace exist after it), then captures it
    there; every replay adds the step's launches to the kernel wrappers'
    counters.  Subclasses keep the static buffers the step reads and
    writes, and the step's output is ``logits``."""

    def __init__(self, n_upload: int, device, batch: int):
        self.device, self.batch = device, batch
        self._host = torch.zeros(n_upload, dtype=torch.int32)
        if torch.device(device).type == "cuda":
            self._host = self._host.pin_memory()
        self._host_np = self._host.numpy()
        self._inp = torch.zeros(n_upload, dtype=torch.int32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self._launches: Optional[K.CapturedLaunches] = None
        self.replays = 0

    def upload(self) -> None:
        """The host buffer to the device, in stream order (the loop's
        synchronisation on K5's outputs comes before the host writes the
        buffer again)."""
        self._inp.copy_(self._host, non_blocking=True)

    def replay(self, run, eager=None) -> torch.Tensor:
        """Upload, capture ``run`` on first use (after ``eager``, by
        default ``run``, once eagerly), replay; returns the static output
        of ``run``."""
        self.upload()
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture(run, eager or run)
            self.graph.replay()
        self._launches.add()
        self.replays += 1
        return self.logits

    def _capture(self, run, eager) -> None:
        with tracer.span("gwt.step.capture", rows=self.batch):
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                eager()              # writes the step's K/V, as the replay
            graph = torch.cuda.CUDAGraph()
            with K.CapturedLaunches() as launches, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                self.logits = run()
            cur.wait_stream(side)
            self.graph, self._launches = graph, launches


class StepGraph(GraphedStep):
    """One batch shape's ``decoder_step`` captured as a CUDA graph
    (``GraphedStep``), with the static buffers that the capture reads and
    writes: the step's token ids, positions and cache slot (beside them
    the sampler's state, so a step makes one upload), the prompt lengths
    ``lo``, the self-KV cache, and the cross-KV (``StepGraphs.cross_kv``'s
    buffer).  The prompt pass writes the self-KV in place (its ``out=``);
    the graph's kernels write ``logits``."""

    def __init__(self, statics: WindowStatics, device: torch.device,
                 cdtype: torch.dtype, xkv):
        config = statics.config
        B = statics.batch
        L, S = config.n_text_layer, config.n_text_state
        # the step's upload: tokens (B), positions (B), slot (1), padding
        # to 16 bytes, the sampler's state (B, 7)
        self._state_at = -(-(2 * B + 1) // 4) * 4
        super().__init__(self._state_at + 7 * B, device, B)
        self.kv_group, self.prompt_pad = statics.kv_group, statics.prompt_pad
        cap = round_cache_len(statics.prompt_pad + statics.n_max)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.kv = KVCache(k=zeros((L, B, cap, S), cdtype),
                          v=zeros((L, B, cap, S), cdtype))
        self.xkv = xkv
        self.lo = zeros((B,), torch.int32)
        self.state = self._inp[self._state_at:].view(B, 7)

    def load(self, kv: KVCache, xkv, n_prompt: np.ndarray) -> None:
        """A window's prompt lengths into ``lo``; its caches must be the
        graph's own buffers, written in place."""
        if (kv.k is not self.kv.k or kv.v is not self.kv.v
                or type(xkv) is not type(self.xkv)
                or any(a is not b for a, b in zip(xkv[:-1], self.xkv[:-1]))):
            raise ValueError("StepGraph.load: the caches are not the graph's "
                             "buffers")
        self.lo.copy_(torch.from_numpy(np.array(n_prompt, np.int32)))

    def set_state(self, state: np.ndarray) -> torch.Tensor:
        """The sampler's state (B, 7) for the next upload; returns its
        device view."""
        self._host_np[self._state_at:] = state.reshape(-1)
        return self.state

    def step(self, params, config: WhisperConfig, tokens: np.ndarray,
             positions: np.ndarray, slot: int) -> torch.Tensor:
        """One decoder step by replay (by capture first); returns the
        static logits (B, V) f32."""
        B = self.batch
        self._host_np[:B] = tokens
        self._host_np[B:2 * B] = positions
        self._host_np[2 * B] = slot
        return self.replay(lambda: decoder_step(
            params, config, self._inp[:B], self._inp[B:2 * B], self.kv,
            self.xkv, lo=self.lo, slot=self._inp[2 * B:2 * B + 1],
            split=self.prompt_pad, kv_group=self.kv_group)[0])


class StepGraphs:
    """A pipeline's token-loop graph: the cross-KV buffer that its windows'
    ``cross_kv`` writes, and one captured step (``StepGraph``) that reads
    it, for one batch shape at a time.  A window of another shape captures
    anew, and a cross-KV of another shape or other weights drops the step
    with the buffer.  Both stay allocated between windows.  One window uses
    them at a time, as the pipeline runs one ``full`` at a time."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        """Drop the buffer and the captured step."""
        self._params = self._xkv_key = self._xkv = None
        self._key = self._graph = None

    def cross_kv(self, params, config: WhisperConfig, enc: torch.Tensor,
                 quant: bool, tp=None):
        """The cross-KV of ``enc`` (int8 with ``quant``), written into the
        buffer a step graph reads where one can replay (a CUDA device, one
        device), else a new one: ``models/model.py::cross_kv``, then
        ``quantize_cross_kv``.  It holds until the next call."""
        out, key = None, None
        if _one_cuda_device(enc.device, tp):
            key = (enc.device, enc.shape[0], enc.shape[1], quant)
            if params is not self._params or key != self._xkv_key:
                self.clear()
                self._params = params
            out = self._xkv
        xkv = cross_kv(params, config, enc, tp=tp,
                       out=None if quant else out)
        if quant:
            xkv = quantize_cross_kv(xkv, config.n_text_head // tp_size(tp),
                                    out=out)
        if key is not None:
            self._xkv_key, self._xkv = key, xkv
        return xkv

    def get(self, params, statics: WindowStatics,
            xkv) -> Optional[StepGraph]:
        """The StepGraph of this window's shape; None where the steps run
        eagerly: not ``graph_eligible``, or ``xkv`` is not the buffer
        (a cross-KV made elsewhere than ``cross_kv``)."""
        if (not graph_eligible(statics, xkv.device) or params is not
                self._params or self._xkv is None
                or xkv[0] is not self._xkv[0]):
            return None
        key = (statics.batch, statics.kv_group, statics.prompt_pad,
               statics.n_max, w8a8_default())
        if key != self._key:
            self._graph = None           # its buffers go before the new ones
            self._key, self._graph = key, StepGraph(
                statics, xkv.device, param_compute_dtype(params), self._xkv)
        return self._graph


def prompt_pass_per_stream(params, config: WhisperConfig,
                           prompt: torch.Tensor, n_prompt: np.ndarray,
                           xkv, n_max: Optional[int] = None, tp=None,
                           out: Optional[KVCache] = None):
    """Per-stream prompt decode: each row its own prompt (B, P) with its
    own length; ``xkv`` a CrossKV or an int8 QuantCrossKV.  The cache holds
    P + n_max slots; the padded prompt capacity P is the decode loop's
    ``split``.  ``out``: a cache of that shape, zeroed and written in
    place (a ``StepGraph``'s).  Returns (last_logits (B, V) f32, kv)."""
    B, P = prompt.shape
    dev = prompt.device
    kv0 = init_kv_cache(config, B,
                        cache_len=P + (n_max if n_max is not None
                                       else config.n_text_ctx // 2 - 4),
                        dtype=param_compute_dtype(params), device=dev, tp=tp,
                        out=out)
    positions = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    n_prompt_t = torch.as_tensor(np.asarray(n_prompt, np.int64).reshape(B),
                                 device=dev)
    logits, kv = decoder_dense(params, config, prompt, positions, kv0, xkv,
                               n_valid=n_prompt_t,
                               logit_rows=n_prompt_t - 1, tp=tp)
    return logits[:, 0], kv


def prompt_pass_grouped(params, config: WhisperConfig, prompt: torch.Tensor,
                        n_prompt: np.ndarray, xkv, n_dec: int,
                        n_max: Optional[int] = None, repeat_kv: bool = True,
                        tp=None, out: Optional[KVCache] = None):
    """Grouped prompt pass: G streams decode their prompts ONCE, then the
    logits and self-KV repeat to each stream's n_dec decoder rows
    (kv_cache_seq_cp 0 -> j per stream, whisper.cpp:5277).  With
    ``repeat_kv=False`` the self-KV keeps its G rows: the split-cache beam
    loop stores the prompt once per group.  ``out``: the repeated cache is
    written there (a ``StepGraph``'s); None writes a new one."""
    last, kv = prompt_pass_per_stream(params, config, prompt, n_prompt, xkv,
                                      n_max=n_max, tp=tp,
                                      out=out if n_dec == 1 else None)
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


def run_decode_loop(params, config: WhisperConfig, fctx: FilterContext,
                    statics: WindowStatics, xkv, kv: KVCache,
                    last_logits: torch.Tensor, n_prompt, temperature: float,
                    seek, seek_end, rng_seed: int,
                    graph: Optional[StepGraph] = None) -> WindowResult:
    """The autoregressive window loop given a finished prompt pass.
    ``n_prompt``, ``seek`` and ``seek_end`` are per row (or scalars).  In
    split-cache beam mode ``kv`` is the prompt pass's cache with one row
    per group (``prompt_pass_grouped(..., repeat_kv=False)``); otherwise it
    has one row per decoder.  ``graph``: the StepGraph of this shape
    (``StepGraphs.get``): ``kv`` and ``xkv`` are its buffers, and its
    replay runs the decoder steps; None runs them eagerly."""
    B, N_MAX = statics.batch, statics.n_max
    eot, beg = fctx.token_eot, fctx.token_beg
    dev = last_logits.device
    n_prompt = np.broadcast_to(np.asarray(n_prompt, np.int32), (B,))
    seek = np.broadcast_to(np.asarray(seek, np.int32), (B,))
    seek_end = np.broadcast_to(np.asarray(seek_end, np.int32), (B,))
    if graph is None:
        lo = torch.as_tensor(n_prompt.copy(), device=dev)
    elif not graph_eligible(statics, dev):
        raise ValueError("run_decode_loop: this window's steps run eagerly")
    else:
        graph.load(kv, xkv, n_prompt)

    beam = statics.strategy == "beam"
    KB = statics.beam_size
    split = use_split_cache(statics)
    kv_prompt = rowmap = kv_alt = None
    if split:
        # the prompt K/V once per group; the live K/V per beam in a fresh
        # cache written at slot i; every beam owns its own row at first
        cp = round_cache_len(statics.prompt_pad)
        kv_prompt = KVCache(k=kv.k[:, :, :cp].contiguous(),
                            v=kv.v[:, :, :cp].contiguous())
        nl = round_cache_len(N_MAX)
        shape = (kv.k.shape[0], B, nl, kv.k.shape[3])
        kv = KVCache(k=torch.zeros(shape, dtype=kv.k.dtype, device=dev),
                     v=torch.zeros(shape, dtype=kv.v.dtype, device=dev))
        rowmap = np.tile((np.arange(B, dtype=np.int32) % KB)[:, None],
                         (1, nl))
    elif beam:
        kv_alt = KVCache(k=torch.empty_like(kv.k), v=torch.empty_like(kv.v))

    tokens = np.zeros((B, N_MAX), np.int32)
    tok_p = np.zeros((B, N_MAX), np.float32)
    tok_plog = np.zeros((B, N_MAX), np.float32)
    tok_pt = np.zeros((B, N_MAX), np.float32)
    tok_ptsum = np.zeros((B, N_MAX), np.float32)
    tok_tid = np.zeros((B, N_MAX), np.int32)
    completed = np.zeros(B, bool)
    failed = np.zeros(B, bool)
    has_ts = np.zeros(B, bool)
    seek_delta = np.full(B, SEEK_DELTA_FULL, np.int32)
    result_len = np.zeros(B, np.int32)
    sum_lp = np.zeros(B, np.float32)
    argmax_flag = int(statics.greedy_argmax)
    filt = dict(temperature=temperature, eot=eot, beg=beg,
                space_id=fctx.space_id, max_initial_tid=fctx.max_initial_tid,
                suppress_blank=statics.suppress_blank,
                no_timestamps=statics.no_timestamps)

    def step_state(i: int) -> torch.Tensor:
        """Step i's sampler state on the device: first-step flag, the last
        two tokens, the step, has_ts, seek_delta, the argmax flag."""
        last = tokens[:, i - 1] if i > 0 else np.full(B, -1, np.int32)
        penult = tokens[:, i - 2] if i > 1 else np.full(B, -1, np.int32)
        state = np.stack([np.full(B, int(i == 0)), last, penult,
                          np.full(B, i), has_ts, seek_delta,
                          np.full(B, argmax_flag)], axis=1).astype(np.int32)
        if graph is not None:
            return graph.set_state(state)    # uploaded with the step
        return torch.from_numpy(state).to(dev)

    logits = last_logits.float().contiguous()
    with tracer.span("gwt.step.state"):
        state = step_state(0)
        if graph is not None:
            graph.upload()
    for i in range(N_MAX):
        live = ~(completed | failed)
        # ONE device -> host transfer of the step's outputs per step (int32
        # columns ride bit-exactly as float32 views)
        with tracer.span("gwt.step.sample"):
            if beam:
                out = fused_filter_topk(logits, fctx.static_suppress, state,
                                        K=KB, **filt)
                packed = torch.cat(
                    [out.plog, out.ids.view(torch.float32), out.p,
                     torch.stack([out.pt, out.ptsum,
                                  out.tid.view(torch.float32)], dim=1)],
                    dim=1).cpu().numpy()
            else:
                out = fused_filter_sample(
                    logits, fctx.static_suppress, state,
                    seed=_attempt_seed(rng_seed, i), **filt)
                packed = torch.stack([out.token.view(torch.float32), out.p,
                                      out.plog, out.pt, out.ptsum,
                                      out.tid.view(torch.float32)]
                                     ).cpu().numpy()

        with tracer.span("gwt.step.state"):
            if beam:
                m = _merge_beam(
                    packed[:, :KB], packed[:, KB:2 * KB].view(np.int32),
                    packed[:, 2 * KB:3 * KB], packed[:, 3 * KB],
                    packed[:, 3 * KB + 1],
                    np.ascontiguousarray(packed[:, 3 * KB + 2]).view(
                        np.int32),
                    sum_lp, live, beg)
                # the candidate-carried state follows the source beams
                # (whisper.cpp:5332, 5397-5400); completed / failed stay
                src = m.src
                tokens, tok_p, tok_plog = (tokens[src], tok_p[src],
                                           tok_plog[src])
                tok_pt, tok_ptsum, tok_tid = (tok_pt[src], tok_ptsum[src],
                                              tok_tid[src])
                has_ts, seek_delta = has_ts[src], seek_delta[src]
                result_len = result_len[src]
                if split:
                    rowmap = permute_rowmap(rowmap, src, i, KB)
                else:
                    kv, kv_alt = (KVCache(*reorder_kv_live(
                        kv.k, kv.v,
                        torch.from_numpy(src.astype(np.int32)).to(dev),
                        statics.prompt_pad + i, out=kv_alt)), kv)
                ids, p, plog, pt, ptsum, tid = (m.ids, m.p, m.plog, m.pt,
                                                m.ptsum, m.tid)
                new_sum = m.score
            else:
                ids = packed[0].view(np.int32)
                p, plog, pt, ptsum = (packed[1], packed[2], packed[3],
                                      packed[4])
                tid = packed[5].view(np.int32)
                new_sum = sum_lp + plog

            tokens[live, i] = ids[live]
            tok_p[live, i] = p[live]
            tok_plog[live, i] = plog[live]
            tok_pt[live, i] = pt[live]
            tok_ptsum[live, i] = ptsum[live]
            tok_tid[live, i] = tid[live]
            sum_lp = np.where(live, new_sum, sum_lp).astype(np.float32)
            # ---- decoder state machine (whisper.cpp:5421-5507)
            is_ts_tok = ids > beg
            sd_new = (2 * (ids - beg)).astype(np.int32)
            back_in_time = (has_ts & (seek_delta > sd_new)
                            & (result_len < i))
            fail_ts = live & is_ts_tok & back_in_time
            take_ts = live & is_ts_tok & ~back_in_time
            seek_delta = np.where(take_ts, sd_new, seek_delta)
            result_len = np.where(take_ts, i + 1,
                                  result_len).astype(np.int32)
            has_ts = has_ts | take_ts
            failed = failed | fail_ts

            alive = live & ~fail_ts
            end_of_text = ids == eot
            max_tok = statics.max_tokens > 0 and i >= statics.max_tokens
            end_of_audio = has_ts & (seek + seek_delta + 100 >= seek_end)
            wants_end = alive & (end_of_text | max_tok | end_of_audio)

            zero_res = result_len == 0
            rescue = seek + seek_delta + 100 >= seek_end
            fail_zero = wants_end & zero_res & ~rescue
            result_len = np.where(wants_end & zero_res & rescue, i + 1,
                                  result_len).astype(np.int32)
            failed = failed | fail_zero
            complete_now = wants_end & ~(zero_res & ~rescue)
            if statics.single_segment:
                result_len = np.where(complete_now, i + 1,
                                      result_len).astype(np.int32)
                seek_delta = np.where(complete_now, SEEK_DELTA_FULL,
                                      seek_delta)
            completed = completed | complete_now

            if statics.test_mode:
                # stub checkpoint: complete immediately
                # (whisper.cpp:5492-5497)
                still = alive & ~complete_now & ~fail_zero
                seek_delta = np.where(still, SEEK_DELTA_FULL, seek_delta)
                completed = completed | still

            # repetition-loop failure on the final step
            # (whisper.cpp:5500-5506)
            if i == N_MAX - 1:
                rep = ((result_len == 0)
                       | (seek_delta < SEEK_DELTA_FULL // 2))
                failed = failed | (alive & ~complete_now & rep)
            seek_delta = seek_delta.astype(np.int32)
            finished = i == N_MAX - 1 or np.all(completed | failed)
            if not finished:
                state = step_state(i + 1)

        if finished:
            break
        # ---- next-step logits; the cache slot is the batch-uniform
        # prompt_pad + i (live slot i in the split cache), the true position
        # n_prompt + i drives the positional embedding
        with tracer.span("gwt.step.forward"):
            if graph is not None:
                logits = graph.step(params, config, tokens[:, i],
                                    n_prompt + i, statics.prompt_pad + i)
            else:
                logits, kv = decoder_step(
                    params, config,
                    torch.from_numpy(tokens[:, i].copy()).to(dev),
                    torch.from_numpy((n_prompt + i).astype(np.int32)).to(dev),
                    kv, xkv, lo=lo,
                    slot=i if split else statics.prompt_pad + i,
                    split=statics.prompt_pad, kv_group=statics.kv_group,
                    kv_prompt=kv_prompt,
                    rowmap=torch.from_numpy(rowmap).to(dev) if split else None,
                    tp=statics.tp)

    return WindowResult(
        tokens=tokens, tok_p=tok_p, tok_plog=tok_plog, tok_pt=tok_pt,
        tok_ptsum=tok_ptsum, tok_tid=tok_tid, completed=completed,
        failed=failed, has_ts=has_ts, seek_delta=seek_delta,
        result_len=result_len, sum_logprobs_all=sum_lp, n_steps=i + 1,
        graph_steps=0 if graph is None else i + 1)


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
               seed: int = 0, strategy: str = "greedy", beam_size: int = 1,
               force_merged_cache: bool = False) -> WindowResult:
        """``xkv`` is a CrossKV or an int8 QuantCrossKV; the steps replay
        a CUDA graph where ``graphs.get`` gives one (``xkv`` made by
        ``graphs.cross_kv``).  ``force_merged_cache`` (tests) takes the
        wide configurations' beam path, the merged cache reordered by K8,
        at any width."""
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
            beam_size=beam_size, force_merged_cache=force_merged_cache,
            tp=self.tp)
        graph = self.graphs.get(params, statics, xkv)
        with tracer.span("gwt.prompt", rows=1):
            prompt = np.zeros((1, pad), np.int32)
            prompt[0, :P] = prompt_tokens
            last, kv = prompt_pass_grouped(
                params, config, torch.from_numpy(prompt).to(xkv.device),
                np.asarray([P]), xkv, n_decoders, n_max=n_max,
                repeat_kv=not use_split_cache(statics), tp=self.tp,
                out=None if graph is None else graph.kv)
        with tracer.span("gwt.token_loop") as sp:
            res = run_decode_loop(params, config, self.fctx, statics, xkv,
                                  kv, last, P, temperature, seek, seek_end,
                                  seed, graph=graph)
            sp.set(steps=res.n_steps, graph_steps=res.graph_steps)
        return res
