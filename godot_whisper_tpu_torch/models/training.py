"""Teacher-forced training / fine-tuning step.

PyTorch port of the JAX package's ``models/training.py``: the mean masked
cross-entropy of the decoder over teacher-forced tokens, its gradient, and
an AdamW update, as one functional step (``train_step`` returns new
tensors and leaves the caller's parameters as they were).

On the card the encoder's self-attention runs the hand-written kernels in
the forward (K2, or K13 above a padded T of 1536) and gets its gradient by
recomputing the kernel's plain function (``ops/attention.py::
RecomputeAttention``); every other operation is plain PyTorch under
autograd.  ``make_optimizer`` is optax 0.2.6's ``adamw`` written out in
torch, with its order of operations and its rounding points, so that a
bf16 step rounds where the JAX package's does.

On a dp x tp mesh (``mesh=``, ``parallel/sharding.py``) each process holds
its tp rank's slices (``shard_params``) and its dp shard's rows of the
batch (``batch_sharding``).  The loss stays the global masked mean: the
masked sum and the mask count are all-reduced over dp.  The collectives
inside the model carry the tp gradients (``parallel/collectives.py``: a
leaf replicated over tp gets the same gradient on every tp rank), and
every gradient is summed over dp before AdamW, which then runs on the
local slices (optax's ``adamw`` clips no global norm, so nothing else
needs reducing).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.qmatmul import QUANT_TYPES
from ..parallel.collectives import all_reduce, reduce_over
from ..runtime.device import resolve_device
from ..runtime.trace import tracer
from .config import WhisperConfig
from .model import cross_kv, decoder_dense, encoder_forward, init_kv_cache
from .params import params_from_jax, params_to_numpy, tree_leaves, tree_map

Params = Dict[str, Any]


# optax's adamw defaults, which the JAX package's make_optimizer keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


def loss_fn(params: Params, config: WhisperConfig,
            mel: torch.Tensor,       # (B, 2*n_ctx, n_mels) f32
            tokens: torch.Tensor,    # (B, T) int — input tokens
            targets: torch.Tensor,   # (B, T) int — next-token labels
            mask: torch.Tensor,      # (B, T) f32 — loss weights
            audio_ctx: int = 0, mesh=None) -> torch.Tensor:
    """Mean masked cross-entropy of the decoder given encoded audio; on a
    mesh, over every dp shard's rows."""
    B, T = tokens.shape
    dev = tokens.device
    tp = mesh.tp_group if mesh is not None else None
    dp = mesh.dp_group if mesh is not None else None
    enc = encoder_forward(params, config, mel, audio_ctx=audio_ctx or None,
                          tp=tp)
    xkv = cross_kv(params, config, enc, tp=tp)
    kv = init_kv_cache(config, B, dtype=params["decoder"]["token_embed"].dtype,
                       device=dev, tp=tp)
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    n_valid = torch.full((B,), T, dtype=torch.int32, device=dev)
    logits, _ = decoder_dense(params, config, tokens, positions, kv, xkv,
                              n_valid=n_valid, tp=tp)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    total = reduce_over((nll * mask).sum(), dp)
    count = reduce_over(mask.sum(), dp)
    return total / torch.clamp_min(count, 1.0)


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the first and
    second moments, trees of the params' structure and dtypes."""
    count: int
    mu: Params
    nu: Params


class TrainState(NamedTuple):
    params: Params
    opt_state: AdamWState
    step: int


def opt_state_from_jax(opt_state) -> AdamWState:
    """The JAX package's AdamW state (optax's ``adamw`` chain, or its
    ``ScaleByAdamState``, with numpy leaves: ``jax.tree_util.tree_map(
    np.asarray, opt_state)``) -> the port's ``AdamWState`` (CPU tensors):
    the step count, and mu / nu converted as ``params_from_jax`` converts
    the params they shadow (dtypes kept, conv kernels transposed)."""
    adam = opt_state if hasattr(opt_state, "mu") else opt_state[0]
    return AdamWState(count=int(adam.count), mu=params_from_jax(adam.mu),
                      nu=params_from_jax(adam.nu))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """Inverse of ``opt_state_from_jax``: count as an int32 scalar, mu / nu
    in the JAX package's layout as ``params_to_numpy`` gives them (bf16
    widened to float32)."""
    return AdamWState(count=np.int32(state.count),
                      mu=params_to_numpy(state.mu),
                      nu=params_to_numpy(state.nu))


class GradientTransformation(NamedTuple):
    init: Callable[[Params], AdamWState]
    update: Callable[..., Tuple[Params, AdamWState]]


def _scalar(x: float, like: torch.Tensor) -> float:
    """A Python float rounded to ``like``'s dtype, as JAX rounds a weakly
    typed constant to the array's dtype before the operation."""
    return float(torch.tensor(x, dtype=torch.float32).to(like.dtype))


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01
                   ) -> GradientTransformation:
    """optax 0.2.6 ``adamw(lr, weight_decay=weight_decay)`` (b1 ``B1``, b2
    ``B2``, eps ``EPS``, eps_root 0, no mask, no Nesterov), in its order:
    mu = (1-b1) g + b1 mu and nu = (1-b2) g^2 + b2 nu in the parameter's
    dtype; count + 1; each moment divided by 1 - b^count (computed in f32,
    then rounded to the moment's dtype); u = mu_hat / (sqrt(nu_hat) + eps)
    + wd p; the update -lr u.  ``apply_updates`` adds it and rounds to the
    parameter's dtype."""
    def zeros(_, x):
        return torch.zeros_like(x)

    def init(params: Params) -> AdamWState:
        return AdamWState(count=0, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def update(grads: Params, state: AdamWState, params: Params
               ) -> Tuple[Params, AdamWState]:
        count = state.count + 1
        # 1 - b^count in f32 (numpy's powf, as XLA computes it)
        bc1 = torch.tensor(1 - np.float32(B1) ** np.float32(count))
        bc2 = torch.tensor(1 - np.float32(B2) ** np.float32(count))

        def moments(_, g, m, v):
            m = g * _scalar(1 - B1, g) + m * _scalar(B1, m)
            v = (g * g) * _scalar(1 - B2, g) + v * _scalar(B2, v)
            return m, v

        mv = tree_map(moments, grads, state.mu, state.nu)
        mu = tree_map(lambda _, t: t[0], mv)
        nu = tree_map(lambda _, t: t[1], mv)

        def step(_, m, v, p):
            m_hat = m / float(bc1.to(m.dtype))
            v_hat = v / float(bc2.to(v.dtype))
            u = m_hat / (torch.sqrt(v_hat) + _scalar(EPS, v_hat))
            u = u + _scalar(weight_decay, p) * p
            return u * _scalar(-lr, u)

        updates = tree_map(step, mu, nu, params)
        return updates, AdamWState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    """optax's ``apply_updates``: p + u rounded to p's dtype."""
    return tree_map(lambda _, p, u: (p + u).to(p.dtype), params, updates)


def _require_float(params: Params) -> None:
    if any(isinstance(x, QUANT_TYPES) for _, x in tree_leaves(params)):
        raise TypeError("training: quantized weights (QuantTensor / "
                        "Quant4Tensor) are not differentiable; train the "
                        "float parameters and quantize after")


def init_train_state(params: Params, lr: float = 1e-4) -> TrainState:
    """Zero moments on the params' device, step 0."""
    _require_float(params)
    opt = make_optimizer(lr)
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def _batch_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Tensors stay on their device; numpy arrays go to ``device``."""
    dev = None
    out = {}
    for key in ("mel", "tokens", "targets", "mask"):
        x = batch[key]
        if not isinstance(x, torch.Tensor):
            dev = dev or resolve_device(device)
            x = torch.from_numpy(np.asarray(x)).to(dev)
        out[key] = x
    return out


def loss_and_grads(params: Params, config: WhisperConfig, batch: Dict,
                   audio_ctx: int = 0, device=None, mesh=None
                   ) -> Tuple[torch.Tensor, Params]:
    """(loss, gradients): the port's ``jax.value_and_grad(loss_fn)``.  The
    gradients are taken over detached copies of the leaves, so ``params``
    come back untouched and without ``requires_grad``.  The backward runs
    under the conv stem's cuDNN flags (no TF32): the stem sets them for
    its forward only, and a float32 convolution's backward would
    otherwise drop to TF32.  On a ``mesh`` the gradients of this rank's
    slices are summed over dp (one f32 all-reduce per dtype)."""
    _require_float(params)
    b = _batch_tensors(batch, device)
    with torch.enable_grad():
        inputs = tree_map(lambda _, x: x.detach().requires_grad_(True),
                          params)
        loss = loss_fn(inputs, config, b["mel"], b["tokens"], b["targets"],
                       b["mask"], audio_ctx=audio_ctx, mesh=mesh)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            grads = list(torch.autograd.grad(
                loss, [x for _, x in tree_leaves(inputs)]))
    if mesh is not None and mesh.dp_group is not None:
        grads = _sum_over(grads, mesh.dp_group)
    it = iter(grads)
    return loss.detach(), tree_map(lambda *_: next(it), inputs)


def _sum_over(grads, group):
    """Every gradient summed over ``group``: the leaves of one dtype
    flattened into one f32 buffer, one all-reduce each, then split and
    rounded back."""
    out = list(grads)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].float().reshape(-1) for i in idx])
        all_reduce(flat, group, "dp_grads")
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            out[i] = part.reshape(grads[i].shape).to(dtype)
    return out


def train_step(state: TrainState, config: WhisperConfig, batch: Dict,
               lr: float = 1e-4, device=None,
               mesh=None) -> Tuple[TrainState, torch.Tensor]:
    """One full training step: forward, backward, optimizer update.

    ``batch`` holds ``mel`` (B, 2*n_audio_ctx, n_mels) f32, ``tokens`` and
    ``targets`` (B, T) int and ``mask`` (B, T) f32.  Tensors stay on their
    device; numpy arrays go to ``device`` (None is the card).  On a
    ``mesh`` the state holds this rank's slices and the batch this dp
    shard's rows.  Returns the new state (fresh tensors; the old state is
    not modified) and the loss before the step (the global one)."""
    opt = make_optimizer(lr)
    loss, grads = loss_and_grads(state.params, config, batch, device=device,
                                 mesh=mesh)
    with torch.no_grad(), tracer.span(
            "gwt.train.optimizer", device=loss.device,
            leaves=len(tree_leaves(state.params))):
        updates, opt_state = opt.update(grads, state.opt_state,
                                        state.params)
        params = apply_updates(state.params, updates)
    return TrainState(params=params, opt_state=opt_state,
                      step=state.step + 1), loss
