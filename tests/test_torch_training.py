"""The port's training step (models/training.py) against the JAX package's
on the nano config (tiny.en with 2 + 2 layers, S 128, 4 heads, n_audio_ctx
64), B 2, T 8, one row half masked: the loss and every gradient leaf, the
params and AdamW moments after one and two steps, the AdamW update alone
against optax, the encoder attention's recompute backward, the f32-result
matmul's backward, and the paths around them."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from godot_whisper_tpu.models import training as jt
from godot_whisper_tpu.models.params import init_params as jax_init_params
from godot_whisper_tpu_torch import WhisperContext
from godot_whisper_tpu_torch.audio.mel import mel_filterbank
from godot_whisper_tpu_torch.audio.tokenizer import synthetic_vocab
from godot_whisper_tpu_torch.models import loader_ggml
from godot_whisper_tpu_torch.models import model as tm
from godot_whisper_tpu_torch.models import training as tt
from godot_whisper_tpu_torch.models.config import get_config
from godot_whisper_tpu_torch.models.export_ggml import export_checkpoint
from godot_whisper_tpu_torch.models.params import (params_from_jax,
                                                   params_to_numpy,
                                                   tree_leaves)
from godot_whisper_tpu_torch.models.quant import quantize_decoder_int8
from godot_whisper_tpu_torch.ops import attention as A

B, T = 2, 8
LR = 1e-4
# f32 gradients: the same math in another summation order (measured
# 1.3e-6 of the leaf's largest element)
GRAD_F32 = 1e-5
# bf16 gradients: XLA keeps f32 between the fused operations of the
# jitted JAX step where the port rounds each operation to bf16, and the
# gradients are rounded to 8 bits; measured 1.3e-2 of the leaf's largest
# element (encoder pos_embed), about 3 bf16 ulps (2^-8 = 3.9e-3 each)
GRAD_BF16 = 3e-2
MOMENT_F32 = 1e-5   # mu / nu: linear in the gradients
# the loss: f32 measured 1e-7 relative; bf16 3.6e-5 (the logits come from
# bf16 activations rounded at other points, see GRAD_BF16)
LOSS_F32, LOSS_BF16 = 1e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded: these tests share the CPU with other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, n_audio_ctx=64, name="nano")


@pytest.fixture(scope="module")
def batch(cfg):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.n_vocab, (B, T + 1)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0
    return {"mel": rng.standard_normal((B, 2 * cfg.n_audio_ctx, cfg.n_mels)
                                       ).astype(np.float32),
            "tokens": tok[:, :-1], "targets": tok[:, 1:], "mask": mask}


def _jparams(cfg, dtype):
    return jax_init_params(cfg, seed=3, compute_dtype=getattr(jnp, dtype))


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)), tree)


def _port(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))


def _leaf_errors(want, got):
    """{leaf path: max |got - want| / max |want|}; ``want`` a JAX-layout
    tree, ``got`` the port's tree."""
    g = jax.tree_util.tree_leaves(params_to_numpy(got))
    out = {}
    for (path, w), x in zip(jax.tree_util.tree_leaves_with_path(_np(want)),
                            g):
        assert w.shape == x.shape, jax.tree_util.keystr(path)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(x - w).max() / max(np.abs(w).max(), 1e-30))
    return out


@pytest.fixture(scope="module")
def jax_grads(cfg, batch):
    """Jitted ``jax.value_and_grad(loss_fn)`` per case, computed once."""
    cache = {}

    def get(dtype, audio_ctx):
        key = (dtype, audio_ctx)
        if key not in cache:
            mel = batch["mel"][:, :2 * (audio_ctx or cfg.n_audio_ctx)]
            args = [jnp.asarray(x) for x in (mel, batch["tokens"],
                                             batch["targets"],
                                             batch["mask"])]
            f = jax.jit(jax.value_and_grad(
                lambda p: jt.loss_fn(p, cfg, *args, audio_ctx=audio_ctx)))
            cache[key] = f(_jparams(cfg, dtype))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def jax_steps(cfg, batch):
    """The JAX package's f32 state after one and two jitted train_steps,
    and their losses."""
    step = jax.jit(lambda s, b: jt.train_step(s, cfg, b, lr=LR))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    s0 = jt.init_train_state(_jparams(cfg, "float32"), lr=LR)
    s1, l1 = step(s0, jb)
    s2, l2 = step(s1, jb)
    return [s0, s1, s2], [float(l1), float(l2)]


@pytest.mark.parametrize("dtype,audio_ctx,loss_limit,limit", [
    ("float32", 0, LOSS_F32, GRAD_F32), ("float32", 48, LOSS_F32, GRAD_F32),
    ("bfloat16", 0, LOSS_BF16, GRAD_BF16)])
def test_loss_and_grads_match_jax(cfg, batch, jax_grads, dtype, audio_ctx,
                                  loss_limit, limit):
    """The loss within ``loss_limit`` relative and every gradient leaf
    within ``limit`` of its largest element, against jitted
    ``jax.value_and_grad(loss_fn)`` (also with audio_ctx below
    n_audio_ctx)."""
    jl, jg = jax_grads(dtype, audio_ctx)
    b = dict(batch, mel=batch["mel"][:, :2 * (audio_ctx or cfg.n_audio_ctx)])
    loss, grads = tt.loss_and_grads(_port(_jparams(cfg, dtype)), cfg, b,
                                    audio_ctx=audio_ctx, device="cpu")
    assert abs(float(loss) - float(jl)) <= loss_limit * abs(float(jl))
    errs = _leaf_errors(jg, grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= limit, (worst, errs[worst])
    assert all(float(np.abs(g).max()) > 0 for g in jax.tree_util.tree_leaves(
        params_to_numpy(grads["encoder"]["blocks"]["attn"])))


def _update_tol(jstate_next, lr=LR):
    """Per-element tolerance of the params after a step: Adam's update
    m_hat / (sqrt(v_hat) + eps) moves by up to ~2 d / (sqrt(v_hat) + eps)
    when the moments are off by d, and d is at most MOMENT_F32 of the
    leaf's largest first moment; plus 1e-4 of a step and two f32 ulps of
    p for the rounding of p + u.  Where the gradient is near Adam's eps
    this allows a large share of a step, as it must: there the gradient is
    as small as its own rounding noise."""
    adam = jstate_next.opt_state[0]
    c = int(adam.count)

    def tol(m, v):
        m, v = np.asarray(m, np.float32), np.asarray(v, np.float32)
        m_hat = np.abs(m).max() / (1 - 0.9 ** c)
        v_hat = v / (1 - 0.999 ** c)
        return lr * (1e-4 + 2 * MOMENT_F32 * m_hat / (np.sqrt(v_hat) + 1e-8))
    return jax.tree_util.tree_map(tol, adam.mu, adam.nu)


def _assert_state_close(jstate, tstate, tol):
    """mu and nu within MOMENT_F32 of each leaf's largest element; the
    params within ``tol`` (a tree) plus two f32 ulps."""
    adam = jstate.opt_state[0]
    assert tstate.opt_state.count == int(adam.count) == tstate.step
    for name, want, got in (("mu", adam.mu, tstate.opt_state.mu),
                            ("nu", adam.nu, tstate.opt_state.nu)):
        errs = _leaf_errors(want, got)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= MOMENT_F32, (name, worst, errs[worst])
    tol = jax.tree_util.tree_leaves(tol)
    want = jax.tree_util.tree_leaves_with_path(_np(jstate.params))
    got = jax.tree_util.tree_leaves(params_to_numpy(tstate.params))
    for (path, w), x, t in zip(want, got, tol):
        t = t + 2 * np.spacing(np.abs(w))
        assert bool((np.abs(x - w) <= t).all()), jax.tree_util.keystr(path)


def test_train_steps_match_jax(cfg, batch, jax_steps):
    """Params, mu and nu after one and after two f32 train_steps against
    the jitted JAX step (the params' tolerance adds up over the steps: a
    step moves the params from where the last one left them); the loss
    falls on the repeated batch."""
    js, jl = jax_steps
    state = tt.init_train_state(_port(_jparams(cfg, "float32")), lr=LR)
    losses, tol = [], None
    for i in (1, 2):
        state, loss = tt.train_step(state, cfg, batch, lr=LR, device="cpu")
        losses.append(float(loss))
        assert abs(losses[-1] - jl[i - 1]) <= LOSS_F32 * abs(jl[i - 1])
        step_tol = _update_tol(js[i])
        tol = step_tol if tol is None else jax.tree_util.tree_map(
            np.add, tol, step_tol)
        _assert_state_close(js[i], state, tol)
    assert losses[1] < losses[0]


def test_step_two_from_carried_jax_state(cfg, batch, jax_steps):
    """The port started from the JAX package's params and AdamW state after
    step 1 takes step 2 as the JAX package does."""
    js, jl = jax_steps
    s1 = js[1]
    state = tt.TrainState(
        params=_port(s1.params),
        opt_state=tt.opt_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            s1.opt_state)),
        step=int(s1.step))
    state, loss = tt.train_step(state, cfg, batch, lr=LR, device="cpu")
    assert abs(float(loss) - jl[1]) <= LOSS_F32 * jl[1]
    _assert_state_close(js[2], state, _update_tol(js[2]))


def test_opt_state_round_trip(cfg, jax_steps):
    """optax's state -> the port's AdamWState -> numpy is the identity (bf16
    moments widened exactly), and back into optax it takes the same
    step."""
    s1 = jax_steps[0][1]
    got = tt.opt_state_to_numpy(tt.opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, s1.opt_state)))
    want = s1.opt_state[0]
    assert got.count == int(want.count) and got.count.dtype == np.int32
    for a, b in ((want.mu, got.mu), (want.nu, got.nu)):
        for x, y in zip(jax.tree_util.tree_leaves(_np(a)),
                        jax.tree_util.tree_leaves(b)):
            assert np.array_equal(x, y)
    rebuilt = (optax.ScaleByAdamState(
        count=jnp.asarray(got.count), mu=got.mu, nu=got.nu),
        optax.EmptyState(), optax.EmptyState())
    assert jax.tree_util.tree_structure(rebuilt) == \
        jax.tree_util.tree_structure(s1.opt_state)


def test_adamw_matches_optax(cfg):
    """The port's AdamW alone against optax 0.2.6's ``adamw`` (eager) on the
    same bf16 params and the same gradients, three steps: every bf16 leaf
    (params, mu, nu) bit for bit; the f32 leaves (norms, biases, positional
    embeddings) within 1e-6 relative plus a millionth of a step (an ulp
    or two where XLA's f32 arithmetic rounds otherwise)."""
    jp = _jparams(cfg, "bfloat16")
    tp = _port(jp)
    opt, topt = optax.adamw(LR, weight_decay=0.01), tt.make_optimizer(LR)
    js, ts = opt.init(jp), topt.init(tp)
    rng = np.random.default_rng(5)
    for _ in range(3):
        # gradients of every scale from 1e-10 to 1e-2, leaf by leaf
        gj = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32) * 10.0 ** rng.uniform(-10, -2)).astype(p.dtype),
            jp)
        uj, js = opt.update(gj, js, jp)
        jp = optax.apply_updates(jp, uj)
        ut, ts = topt.update(_port(gj), ts, tp)
        tp = tt.apply_updates(tp, ut)
        for want, got, what in ((jp, tp, "params"), (js[0].mu, ts.mu, "mu"),
                                (js[0].nu, ts.nu, "nu")):
            for (path, w), x in zip(
                    jax.tree_util.tree_leaves_with_path(want),
                    jax.tree_util.tree_leaves(params_to_numpy(got))):
                w32 = np.asarray(w.astype(jnp.float32))
                where = (what, jax.tree_util.keystr(path))
                if w.dtype == jnp.bfloat16:
                    assert np.array_equal(w32, x), where
                else:
                    # a millionth of a step (params) or of the leaf's
                    # largest moment, beside 1e-6 relative
                    scale = LR if what == "params" else np.abs(w32).max()
                    assert bool((np.abs(x - w32) <= 1e-6 * (
                        np.abs(w32) + scale)).all()), where
    assert ts.count == int(js[0].count) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plain,t,t_valid", [
    (A.attention_bh_sp_plain, 100, 77),
    (A.attention_bh_blocked_plain, 1100, 1037)], ids=["K2", "K13"])
def test_recompute_attention_backward(dtype, plain, t, t_valid):
    """``RecomputeAttention`` (its forward given the plain function, as the
    CPU has no kernel) gives the gradient of direct autograd through the
    plain function bit for bit, with keys >= t_valid masked: their k and v
    get exactly zero."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, w = (torch.randn(3, t, 32, generator=gen).to(
        getattr(torch, dtype)) for _ in range(4))

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        out.backward(w)
        return out.detach(), [x.grad for x in xs]

    out_f, g_f = grads(lambda a, b, c: A.RecomputeAttention.apply(
        a, b, c, t_valid, plain, plain))
    out_p, g_p = grads(lambda a, b, c: plain(a, b, c, t_valid))
    assert torch.equal(out_f, out_p)
    for a, b in zip(g_f, g_p):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a.float()).all()) and float(
            a.float().abs().max()) > 0
    assert float(g_f[1][:, t_valid:].float().abs().max()) == 0.0
    assert float(g_f[2][:, t_valid:].float().abs().max()) == 0.0


def test_matmul_f32_backward_is_jax_transpose():
    """``_MatmulF32``'s backward (the card's bf16 route under autograd)
    against JAX's transpose of a ``preferred_element_type=float32`` dot:
    bf16 gradients within one bf16 ulp (f32 sums in another order)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    g = rng.standard_normal((24, 40)).astype(np.float32)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jnp.dot(
        a, b, preferred_element_type=jnp.float32), xj, wj)
    want = vjp(jnp.asarray(g))
    ctx = types.SimpleNamespace(saved_tensors=(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16)))
    got = tm._MatmulF32.backward(ctx, torch.from_numpy(g))
    for a, b in zip(want, got):
        assert b.dtype == torch.bfloat16
        a = np.asarray(a.astype(jnp.float32))
        b = b.float().numpy()
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
        assert bool((np.abs(a - b) <= ulp).all())


def test_conv_stem_backward_runs_without_tf32(cfg, batch, monkeypatch):
    """``loss_and_grads`` takes the gradient with cuDNN's TF32 off, as the
    conv stem's forward sets it (a float32 convolution's backward would
    otherwise run in TF32 on the card), and restores the flag after."""
    seen = []
    stem = tm.conv_stem

    def watched(enc, mel, tp=None):
        out = stem(enc, mel, tp)
        out.register_hook(
            lambda g: seen.append(torch.backends.cudnn.allow_tf32))
        return out

    monkeypatch.setattr(tm, "conv_stem", watched)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tt.loss_and_grads(_port(_jparams(cfg, "float32")), cfg, batch,
                          device="cpu")
        assert seen == [False]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_train_step_is_functional(cfg, batch):
    """The caller's params come back untouched and without requires_grad;
    the new state holds fresh tensors that need no grad either."""
    params = _port(_jparams(cfg, "float32"))
    before = [x.clone() for _, x in tree_leaves(params)]
    state = tt.init_train_state(params, lr=LR)
    new, _ = tt.train_step(state, cfg, batch, lr=LR, device="cpu")
    for (_, a), b in zip(tree_leaves(params), before):
        assert not a.requires_grad and torch.equal(a, b)
    for tree in (new.params, new.opt_state.mu, new.opt_state.nu):
        assert not any(x.requires_grad for _, x in tree_leaves(tree))
    assert state.step == 0 and state.opt_state.count == 0
    assert new.params["encoder"]["conv1"]["w"] is not params[
        "encoder"]["conv1"]["w"]


def test_quantized_tree_raises(cfg, batch):
    """Quantized weights are not differentiable: both entry points refuse
    them."""
    q = quantize_decoder_int8(_port(_jparams(cfg, "bfloat16")))
    with pytest.raises(TypeError, match="not differentiable"):
        tt.init_train_state(q)
    with pytest.raises(TypeError, match="not differentiable"):
        tt.loss_and_grads(q, cfg, batch, device="cpu")


def test_trained_params_round_trip_through_ggml_f32(cfg, batch, tmp_path):
    """Params trained by the port go out through ``export_checkpoint`` as
    an F32 ggml file and come back through ``from_file`` bit for bit."""
    state = tt.init_train_state(_port(_jparams(cfg, "float32")), lr=LR)
    state, _ = tt.train_step(state, cfg, batch, lr=LR, device="cpu")
    path = str(tmp_path / "trained.bin")
    export_checkpoint(path, state.params, cfg, mel_filterbank(cfg.n_mels),
                      synthetic_vocab(cfg), ttype=loader_ggml.GGML_TYPE_F32)
    ctx = WhisperContext.from_file(path, compute_dtype=torch.float32,
                                   device="cpu")
    want = dict(tree_leaves(state.params))
    got = dict(tree_leaves(ctx.pipeline.params))
    assert want.keys() == got.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key
