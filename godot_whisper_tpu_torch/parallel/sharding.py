"""The ("dp", "tp") mesh of processes and the tensor-parallel weight layout.

Port of the JAX package's ``parallel/sharding.py``.  Its design holds:
utterance streams are data-parallel over ``dp``, weights tensor-parallel
over ``tp`` in Megatron's pattern (q / k / v and the MLP's up-projection
split on their output features, the out-projection and the
down-projection on their input features, the token embedding on its
features because no vocabulary size divides a power-of-two tp).  Where
JAX annotates and GSPMD partitions one program, PyTorch runs one process
per device: ``make_mesh`` builds the process groups, ``shard_params``
returns THIS rank's slices of a full tree, and the model code calls the
collectives itself (``parallel/collectives.py``, ``models/model.py``).

A rank's place is (dp_index, tp_index) = divmod(rank, tp): a tp group is
``tp`` consecutive ranks.  The specs are the JAX package's, as plain
tuples of None / "tp", in the port's layout (the conv kernels are
(out, in, width) here, so their "tp" axis is the first).

Three departures from the JAX layout, each forced by explicit slicing:

- ``tp`` must divide the heads: the kernels attend whole heads, where
  GSPMD may split one;
- the fused ``wqkv`` / ``bqkv`` of a quantized decoder are regrouped, so
  rank r holds [q_r | k_r | v_r] (JAX's contiguous column block would hand
  rank 0 all of q and half of k);
- an int4 leaf sharded on its contraction axis stays whole on every rank
  where a shard would split a quantization group of 128 rows (K10 needs
  whole groups); its input is gathered instead (``models/model.py::
  _row_proj``).

Quantize before sharding: int8 scales are absmax over the contraction
axis, which a row-parallel shard would cut.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..models.config import WhisperConfig
from ..ops.qmatmul import (QUANT_TYPES, Quant4Tensor, QuantTensor,
                           reduced_axis)
from ..runtime.device import resolve_device
from .collectives import Group

Spec = tuple


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's view of a ("dp", "tp") mesh: its rank and
    coordinates, its device, the tp and dp groups it belongs to (None at
    width 1), and gloo groups for host values: one over every rank, and
    one over this rank's tp group (None at tp 1)."""
    dp: int
    tp: int
    rank: int = 0
    device: Any = None
    tp_group: Optional[Group] = None
    dp_group: Optional[Group] = None
    host_group: Any = None
    tp_host_group: Any = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def world(self) -> int:
        return self.dp * self.tp


def local_world_size() -> int:
    """Processes on this host: torchrun's LOCAL_WORLD_SIZE, else every
    process of the run (a run joined by a localhost coordinator)."""
    env = os.environ.get("LOCAL_WORLD_SIZE")
    if env:
        return int(env)
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device=None) -> torch.device:
    """The device of this process: "cpu" when asked, else
    ``cuda:{local_rank % device_count}`` (ranks share a card when there
    are more ranks than cards)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return resolve_device(device)
    resolve_device("cuda")   # raises without a card
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank % local_world_size()))
    return torch.device("cuda", local % torch.cuda.device_count())


def check_tp(config: WhisperConfig, tp: int) -> None:
    """tp must divide both head counts: the kernels attend whole heads."""
    for what, n in (("n_audio_head", config.n_audio_head),
                    ("n_text_head", config.n_text_head)):
        if tp < 1 or n % tp:
            raise ValueError(f"tp={tp} must divide {what}={n} (the "
                             "kernels attend whole heads)")


def make_mesh(dp: int = 1, tp: int = 1, *, device=None) -> Mesh:
    """This rank's mesh over the initialized process group (one process
    per device; ``parallel/dist.py::initialize``): dp * tp must equal the
    world size.  A single process without a process group gets the 1 x 1
    mesh.  Every rank must call this, with the same arguments, in the same
    order."""
    if not dist.is_initialized():
        if dp * tp != 1:
            raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} "
                             "processes; initialize torch.distributed "
                             "first (parallel/dist.py::initialize)")
        return Mesh(dp=1, tp=1, device=rank_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} processes, "
                         f"the run has {world}")
    dp_index, tp_index = divmod(rank, tp)
    tp_group = dp_group = tp_host = None
    # every rank creates every group, in the same order
    for j in range(dp if tp > 1 else 0):
        ranks = list(range(j * tp, (j + 1) * tp))
        g = dist.new_group(ranks)
        h = dist.new_group(ranks, backend="gloo")
        if j == dp_index:
            tp_group, tp_host = Group(g, tp, tp_index), h
    for t in range(tp if dp > 1 else 0):
        g = dist.new_group(list(range(t, world, tp)))
        if t == tp_index:
            dp_group = Group(g, dp, dp_index)
    host = dist.new_group(backend="gloo")
    return Mesh(dp=dp, tp=tp, rank=rank, device=rank_device(device),
                tp_group=tp_group, dp_group=dp_group, host_group=host,
                tp_host_group=tp_host)


# ------------------------------------------------------------------ specs
def _attn_pspecs() -> Dict[str, Spec]:
    return {
        "wq": (None, None, "tp"), "bq": (None, "tp"),
        "wk": (None, None, "tp"),
        "wv": (None, None, "tp"), "bv": (None, "tp"),
        "wo": (None, "tp", None), "bo": (None, None),
        # fused qkv of quantized decoders (models/quant.py), regrouped by
        # shard_params so that each rank holds its q | k | v columns
        "wqkv": (None, None, "tp"), "bqkv": (None, "tp"),
    }


def _mlp_pspecs() -> Dict[str, Spec]:
    return {
        "w0": (None, None, "tp"), "b0": (None, "tp"),
        "w1": (None, "tp", None), "b1": (None, None),
    }


def _ln_pspecs() -> Dict[str, Spec]:
    return {"g": (None, None), "b": (None, None)}


def _quant_spec(qt: QuantTensor, spec: Spec) -> QuantTensor:
    """A weight spec mirrored onto a QuantTensor: ``q`` keeps it, ``s``
    drops the axis the scales were reduced over (the contraction axis)."""
    axis = reduced_axis(qt)
    padded = tuple(spec) + (None,) * (qt.q.dim() - len(spec))
    return QuantTensor(q=spec, s=tuple(a for i, a in enumerate(padded)
                                       if i != axis))


def _quant4_spec(qt: Quant4Tensor, spec: Spec,
                 mesh: Optional[Mesh]) -> Quant4Tensor:
    """A weight spec mirrored onto a Quant4Tensor: ``q`` (..., S/2, O) and
    ``s`` (..., S/G, O) both keep it, except that a contraction-sharded
    ``s`` is replicated where the tp size does not divide its group axis
    (as in the JAX package)."""
    s_axes = list(tuple(spec) + (None,) * (qt.s.dim() - len(spec)))
    group_axis = qt.s.dim() - 2
    if (s_axes[group_axis] is not None and mesh is not None
            and qt.s.shape[group_axis] % mesh.tp != 0):
        s_axes[group_axis] = None
    return Quant4Tensor(q=spec, s=tuple(s_axes))


def quantize_pspecs(specs: Dict[str, Any], params,
                    mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The spec tree pruned to ``params``' structure, with every
    QuantTensor / Quant4Tensor leaf given its pair of specs."""
    def walk(spec_node, param_node):
        if isinstance(param_node, QuantTensor):
            return _quant_spec(param_node, spec_node)
        if isinstance(param_node, Quant4Tensor):
            return _quant4_spec(param_node, spec_node, mesh)
        if isinstance(param_node, dict):
            return {k: walk(spec_node[k], v) for k, v in param_node.items()}
        return spec_node

    return walk(specs, params)


def param_pspecs(config: WhisperConfig) -> Dict[str, Any]:
    """Spec tree matching ``models/params.py``'s layout."""
    enc_blocks = {
        "attn_ln": _ln_pspecs(), "attn": _attn_pspecs(),
        "mlp_ln": _ln_pspecs(), "mlp": _mlp_pspecs(),
    }
    dec_blocks = {
        "attn_ln": _ln_pspecs(), "attn": _attn_pspecs(),
        "cross_attn_ln": _ln_pspecs(), "cross_attn": _attn_pspecs(),
        "mlp_ln": _ln_pspecs(), "mlp": _mlp_pspecs(),
    }
    return {
        "encoder": {
            "pos_embed": (None, None),
            "conv1": {"w": ("tp", None, None), "b": ("tp",)},
            "conv2": {"w": ("tp", None, None), "b": ("tp",)},
            "ln_post": {"g": (None,), "b": (None,)},
            "blocks": enc_blocks,
        },
        "decoder": {
            "pos_embed": (None, None),
            "token_embed": (None, "tp"),
            "ln": {"g": (None,), "b": (None,)},
            "blocks": dec_blocks,
        },
    }


# ---------------------------------------------------------------- slicing
def _slice(x: torch.Tensor, spec: Spec, t: int, n: int) -> torch.Tensor:
    for axis, name in enumerate(spec):
        if name == "tp":
            size = x.shape[axis] // n
            x = x.narrow(axis, t * size, size)
    return x.contiguous()


def _regroup(x: torch.Tensor, t: int, n: int) -> torch.Tensor:
    """Rank t's [q_t | k_t | v_t] columns of a fused (..., 3S) leaf."""
    s = x.shape[-1] // 3
    w = s // n
    return torch.cat([x[..., i * s + t * w:i * s + (t + 1) * w]
                      for i in range(3)], dim=-1).contiguous()


def kept_whole(leaf, spec) -> bool:
    """An int4 leaf sharded on its contraction axis whose shard would split
    a quantization group: ``s`` lost its "tp" (``_quant4_spec``) while
    ``q`` kept it."""
    return (isinstance(leaf, Quant4Tensor) and "tp" in spec.q
            and spec.q.index("tp") == leaf.q.dim() - 2
            and "tp" not in spec.s)


def _shard_leaf(key: str, leaf, spec, t: int, n: int):
    if key in ("wqkv", "bqkv"):
        if isinstance(leaf, QUANT_TYPES):
            return type(leaf)(_regroup(leaf.q, t, n), _regroup(leaf.s, t, n))
        return _regroup(leaf, t, n)
    if isinstance(leaf, QUANT_TYPES):
        if kept_whole(leaf, spec):
            return leaf
        return type(leaf)(_slice(leaf.q, spec.q, t, n),
                          _slice(leaf.s, spec.s, t, n))
    return _slice(leaf, spec, t, n)


def shard_params(params, mesh: Mesh, config: WhisperConfig):
    """This rank's local slices of a full parameter tree (quantized trees
    included: quantize first, then shard).  At tp 1 the tree itself."""
    if mesh.tp == 1:
        return params
    check_tp(config, mesh.tp)
    specs = quantize_pspecs(param_pspecs(config), params, mesh)
    t, n = mesh.tp_index, mesh.tp

    def walk(node, spec, key=""):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], k) for k, v in node.items()}
        return _shard_leaf(key, node, spec, t, n)

    return walk(params, specs)


def unshard_params(shards: List, config: WhisperConfig):
    """The full float tree from every tp rank's local tree, in tp order:
    the inverse of ``shard_params`` for the trees a training step holds
    (parameters, gradients, optimizer moments)."""
    if len(shards) == 1:
        return shards[0]

    def walk(nodes, spec):
        if isinstance(nodes[0], dict):
            return {k: walk([x[k] for x in nodes], spec[k])
                    for k in nodes[0]}
        if isinstance(nodes[0], QUANT_TYPES):
            raise TypeError("unshard_params takes float trees; quantize "
                            "the full tree instead")
        if "tp" not in spec:
            return nodes[0]
        return torch.cat(nodes, dim=spec.index("tp"))

    return walk(shards, param_pspecs(config))


def replicate(tree, mesh: Mesh):
    """Every leaf on the mesh's device, whole."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.to(mesh.device)
    return walk(tree)


def batch_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of a leading-axis dp-sharded batch of ``n_rows``
    (dp must divide it): the dp shard's block, the same on every rank of
    a tp group."""
    if n_rows % mesh.dp:
        raise ValueError(f"dp={mesh.dp} must divide the batch of {n_rows}")
    per = n_rows // mesh.dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
