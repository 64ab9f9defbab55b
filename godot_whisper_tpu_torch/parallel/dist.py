"""Multi-process execution: N processes, one device each, one mesh.

Port of the JAX package's ``parallel/dist.py``.  The reference's only
scale-out is ``whisper_full_parallel``, N host threads in one process
(whisper.cpp:5817-5930); the JAX package joins hosts into one runtime with
``jax.distributed``.  The port follows PyTorch's idiom: one process per
device, joined by ``torch.distributed`` into a ("dp", "tp") mesh
(``parallel/sharding.py``).  Utterance streams shard over ``dp`` (no
traffic between dp shards while they decode); the weights of a tp group
(consecutive ranks, kept inside one host) are sharded over ``tp``.

Per-process flow (``MultiHostBatchTranscriber``):

1. every process passes its LOCAL clips; the clip counts and the mel
   frame capacity are agreed with host all-gathers, and short processes
   pad with dummy rows that never decode;
2. a tp group decodes the union of its ranks' clips as one dp shard, each
   rank running its heads (the logits come out all-reduced, so every rank
   takes the same host decisions);
3. each process keeps the segments of its own clips.

Wire-up (the same on every process, e.g. under torchrun or SLURM)::

    from godot_whisper_tpu_torch.parallel import dist
    dist.initialize()          # GWT_COORDINATOR / GWT_NUM_PROCESSES /
                               # GWT_PROCESS_ID, else torchrun's env://
    mesh = dist.stream_mesh(tp=1)
    mht = dist.MultiHostBatchTranscriber(ctx, mesh)
    segs = mht.transcribe(local_clips, tparams)   # local in, local out

The backend is explicit: NCCL for the card, gloo for the CPU or when the
caller asks (two ranks sharing one card must use gloo: NCCL refuses two
ranks on one device).  Nothing falls back to another backend or device.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..audio.mel import frame_counts
from ..decode.params import TranscribeParams
from .batch import BatchTranscriber
from .sharding import (Mesh, local_world_size, make_mesh, rank_device,
                       replicate, shard_params)


# --------------------------------------------------------------------- init
def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Join this process into a multi-process run.

    The arguments fall back to ``GWT_COORDINATOR`` (host:port) /
    ``GWT_NUM_PROCESSES`` / ``GWT_PROCESS_ID``; with no coordinator,
    torchrun's ``env://`` (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    applies.  ``backend`` None is "nccl", or "gloo" when ``device`` is
    the CPU.  On the card the process's device becomes the current one."""
    coordinator_address = coordinator_address or os.environ.get(
        "GWT_COORDINATOR")
    if num_processes is None and os.environ.get("GWT_NUM_PROCESSES"):
        num_processes = int(os.environ["GWT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("GWT_PROCESS_ID"):
        process_id = int(os.environ["GWT_PROCESS_ID"])
    cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if cpu else "nccl"
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id (or GWT_NUM_PROCESSES / "
                             "GWT_PROCESS_ID)")
        init, kw = f"tcp://{coordinator_address}", dict(
            world_size=num_processes, rank=process_id)
    else:
        if num_processes is not None or process_id is not None:
            raise ValueError("num_processes / process_id need a coordinator "
                             "address (or GWT_COORDINATOR)")
        init, kw = "env://", {}
    dist.init_process_group(backend=backend, init_method=init, **kw)
    if not cpu:
        torch.cuda.set_device(rank_device(device))


def shutdown() -> None:
    """Leave the process group (every process calls it at the end)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def initialize_from_env() -> bool:
    """``initialize()`` iff ``GWT_COORDINATOR`` is set.  Returns whether a
    multi-process run was joined; a single process goes on unchanged."""
    if os.environ.get("GWT_COORDINATOR"):
        initialize()
        return True
    return False


def stream_mesh(tp: int = 1, device=None) -> Mesh:
    """A ("dp", "tp") mesh over every process, tp groups inside one host:
    tp must divide the local world size."""
    n_local = local_world_size()
    if tp < 1 or n_local % tp != 0:
        raise ValueError(f"tp={tp} must divide the local world size "
                         f"{n_local} so tp groups stay host-local")
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(dp=world // tp, tp=tp, device=device)


# ------------------------------------------------------------------ helpers
def _allgather_host(x, mesh: Mesh, tp_only: bool = False) -> List:
    """A host value from every process (with ``tp_only``, from every rank
    of this process's tp group), in rank order, over the mesh's gloo
    group; a process alone in the group gets [x]."""
    group, n = ((mesh.tp_host_group, mesh.tp) if tp_only
                else (mesh.host_group, mesh.world))
    if group is None:
        return [x]
    out = [None] * n
    dist.all_gather_object(out, x, group=group)
    return out


def globalize_params(params, mesh: Mesh, config):
    """A full (possibly quantized) tree -> this rank's slices on the mesh's
    device.  Every process must hold the same full tree."""
    return shard_params(replicate(params, mesh), mesh, config)


# -------------------------------------------------------------- transcriber
class MultiHostBatchTranscriber(BatchTranscriber):
    """Batched multi-stream transcription where the streams span processes.
    Each process passes its LOCAL clips and receives segments for exactly
    those; a tp group decodes its ranks' clips together as one dp shard."""

    def __init__(self, ctx, mesh: Mesh):
        super().__init__(ctx)
        self.mesh = mesh
        pipe = ctx.pipeline
        if mesh.tp > 1 and pipe.tp is not mesh.tp_group:
            if pipe.tp is not None:
                raise ValueError("the context is sharded over another mesh")
            pipe.set_params(globalize_params(pipe.params, mesh, ctx.config),
                            mesh.tp_group)

    def transcribe(self, clips: List[np.ndarray],
                   tparams: Optional[TranscribeParams] = None) -> List:
        pipe = self.ctx.pipeline
        mesh = self.mesh
        tparams = tparams or TranscribeParams()
        if not self._eligible(tparams):
            raise ValueError(
                "multi-host batch mode supports greedy and beam/best_of "
                "decoding without host callbacks/grammar/auto-detect (the "
                "host-interactive paths cannot run SPMD); run those clips "
                "per-host via pipeline.full()")

        # equal local counts: short processes pad with rows that never
        # decode (seek_end 0)
        n_real = len(clips)
        L = max(_allgather_host(n_real, mesh))
        if L == 0:
            return []
        dummy = np.zeros(int(16000 * 1.2), np.float32)
        padded = [np.asarray(c, np.float32) for c in clips]
        padded += [dummy] * (L - n_real)
        # the tp group's rows: its ranks' padded clips, in rank order,
        # gathered over the tp group alone
        group = _allgather_host((padded, n_real), mesh, tp_only=True)
        rows = [c for clips_r, _ in group for c in clips_r]
        real = [i < n_r for _, n_r in group for i in range(L)]

        prompt_init, no_timestamps = self._prompt_init(tparams)
        mel, n_lens = pipe.mel.device_batch(rows)
        # the frame capacity every process agrees on: the global batch's
        f_cap = max(_allgather_host(int(mel.shape[2]), mesh))
        if mel.shape[2] < f_cap:
            mel = torch.nn.functional.pad(mel, (0, f_cap - mel.shape[2]))

        if tparams.initial_prompt:
            init_tokens = pipe.tokenizer.encode(tparams.initial_prompt)
        else:
            init_tokens = list(tparams.prompt_tokens or [])
        s0 = tparams.offset_ms // 10
        seek_ends = [0 if not ok else frame_counts(len(c))[1]
                     if tparams.duration_ms == 0
                     else s0 + tparams.duration_ms // 10
                     for c, ok in zip(rows, real)]
        cd = self._clip_decoder(tparams, len(rows), prompt_init,
                                no_timestamps)
        outs = cd.run(pipe.params, mel, n_lens, [s0] * len(rows), seek_ends,
                      past_init=[list(init_tokens) for _ in rows])
        segments = self._emit(outs, rows, prompt_init, tparams)
        mine = mesh.tp_index * L
        return segments[mine:mine + n_real]
