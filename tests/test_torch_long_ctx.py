"""The long audio context (n_audio_ctx > 1536) in the port against the JAX
package on the CPU: K13's plain version against the TPU kernel
``_flash_kernel`` in interpret mode, the encoder at n_audio_ctx 2000
routed through K13's plain version against the JAX encoder in interpret
mode (pad-native, K13), the port's own CPU route (the einsum at every T,
as the JAX package takes off the TPU) against the JAX encoder off the TPU
in bf16, and ``full`` from a custom-context ggml file token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from chip_smoke import blocked_bf16_limit
from godot_whisper_tpu.audio.mel import mel_filterbank as jmel_filterbank
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jvocab
from godot_whisper_tpu.models import loader_ggml as jloader
from godot_whisper_tpu.models import model as jm
from godot_whisper_tpu.models.export_ggml import export_checkpoint
from godot_whisper_tpu.models.params import init_params as jax_init_params
from godot_whisper_tpu.ops import attention as jattn
from godot_whisper_tpu_torch.models import model as tm
from godot_whisper_tpu_torch.ops import attention as A

# gates open and one decoder row per stream in both packages: every window
# settles on the t = 0 rung (the port's 5-row ladder is held to JAX in
# tests/test_torch_decode.py)
GREEDY = dict(entropy_thold=-1e9, logprob_thold=-1e9, best_of=1,
              temperature_inc=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode (tests/test_ops.py
    does the same)."""
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")


def _nano(pkg):
    return pkg.get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, n_audio_ctx=2000, name="nano")


def _pico(pkg, n_audio_ctx=2000, n_text_layer=3):
    return pkg.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=n_text_layer, n_audio_state=64,
        n_audio_head=2, n_text_state=64, n_text_head=2,
        n_audio_ctx=n_audio_ctx, name="pico")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,d", [(2, 1600, 64), (2, 2048, 32)])
def test_blocked_plain_matches_jax_k13(interpret, dtype, bh, t, d):
    """T = 1600 pads to 2048 > 1536, so the JAX package routes to the
    blocked kernel (K13) and the port's K13 wrapper, on CPU tensors, runs
    its plain version: f32 within 2e-4 (tests/test_ops.py); bf16 within one
    bf16 ulp per element plus one flipped bf16 rounding of a probability
    per row (``blocked_bf16_limit``: f32 scores or exp that differ in the
    last bit round a p on a bf16 midpoint differently; 3 of 204800
    elements need it at (2, 1600, 64))."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((bh, t, d)).astype(np.float32)
               for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.array(jattn.flash_attention_bh(
        *(jnp.asarray(x, jd) for x in (q, k, v))).astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(x).to(td) for x in (q, k, v))
    before = (A.flash_attention_bh.launches, A.flash_attention_long.launches)
    got = A.flash_attention_long(qt, kt, vt)
    assert (A.flash_attention_bh.launches,
            A.flash_attention_long.launches) == before  # CPU: no kernel
    assert got.dtype == td and tuple(got.shape) == (bh, t, d)
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert err.max() < 2e-4
    else:
        lim = blocked_bf16_limit(torch, qt, kt, vt, torch.from_numpy(want))
        assert (err / lim.numpy()).max() <= 1.0
    # the same function with t_valid on an already padded T
    if t % 512 == 0:
        got_tv = A.flash_attention_long(qt, kt, vt, t_valid=t - 77)
        want_tv = A.attention_bh_blocked_plain(qt, kt, vt, t - 77)
        assert torch.equal(got_tv, want_tv)


def test_blocked_plain_differs_from_single_pass_in_bf16():
    """The 512-key blocks are rounding points of K13's function: at phase
    10's shape (6 heads, T 2048, 2000 valid) in bf16 the single-pass
    version (K2's, ``attention_bh_sp_plain``) stays within a few bf16 ulps
    of the blocked one, yet breaks ``blocked_bf16_limit``, the card
    check's limit for K13, so that check can tell the two functions
    apart."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((6, 2048, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    a = A.attention_bh_blocked_plain(q, k, v, 2000)
    b = A.attention_bh_sp_plain(q, k, v, 2000)
    err = (a.float() - b.float()).abs()
    assert float(err.max()) < 4e-3
    lim = blocked_bf16_limit(torch, q, k, v, a, 2000)
    assert float((err / lim).max()) > 1


def test_encoder_long_ctx_matches_jax(interpret, monkeypatch):
    """n_audio_ctx 2000: the JAX encoder runs pad-native at T 2048 with K13
    (interpret mode); the port's CPU encoder is routed to K13's blocked
    plain version at T 2000 (its own CPU route is the einsum).  f32,
    within tests/test_model.py's 2e-4."""
    cfg = _pico(gt)
    jcfg = _pico(jgwt)
    tp = gt.init_params(cfg, seed=2, compute_dtype=torch.float32,
                        device="cpu")
    jp = jax_init_params(jcfg, seed=2, compute_dtype=jnp.float32)
    mel = np.random.default_rng(0).standard_normal(
        (1, 4000, 80)).astype(np.float32)
    calls = []

    def blocked(q, k, v, t_valid=None):
        calls.append(tuple(q.shape))
        return A.attention_bh_blocked_plain(q, k, v, t_valid)
    monkeypatch.setattr(tm, "flash_attention_bh", blocked)
    got = tm.encoder_forward(tp, cfg, torch.from_numpy(mel)).numpy()
    assert calls == [(2, 2000, 32)]
    want = np.asarray(jax.jit(lambda p, x: jm.encoder_forward(p, jcfg, x))(
        jp, jnp.asarray(mel)))
    assert got.shape == want.shape == (1, 2000, 64)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def _bf16_encoder_gap(tp, cfg, jp, jcfg, mel, ctx):
    """(bit-equal share, mean |gap|, max |gap|) of the port's bf16 encoder
    output against the jitted JAX encoder off the TPU, both at audio_ctx
    ``ctx`` on the first 2 ctx mel frames."""
    x = mel[:, :2 * ctx]
    want = np.asarray(jax.jit(
        lambda p, w: jm.encoder_forward(p, jcfg, w, audio_ctx=ctx))(
            jp, jnp.asarray(x)).astype(jnp.float32))
    got = tm.encoder_forward(tp, cfg, torch.from_numpy(x),
                             audio_ctx=ctx).float().numpy()
    assert got.shape == want.shape == (1, ctx, cfg.n_audio_state)
    gap = np.abs(got - want)
    return float((got == want).mean()), float(gap.mean()), float(gap.max())


def test_encoder_long_ctx_bf16_matches_jax_off_tpu(monkeypatch):
    """bf16, n_audio_ctx 2000 (T 2000, padded 2048 > 1536): the port's CPU
    encoder takes the einsum, the JAX package's off-TPU route, and is no
    further from the JAX encoder off the TPU than the port is on the
    short-context route (T 1500, where both packages have always taken the
    einsum): the tolerance is that floor of bf16 roundings moved by f32
    sums in another order, as tests/test_torch_quant.py's
    test_bf16_prompt_pass_floor holds the decoder to its floor.  Limits:
    bit-equal share at least the floor's minus 0.05, mean gap at most 1.15
    times the floor's, max gap at most twice the floor's.  Readings (nano,
    2 audio layers, seed 3): floor 0.511 / 2.41e-3 / 3.5e-2, the einsum
    route 0.520 / 2.36e-3 / 3.1e-2.  The control, the old CPU route
    through K13's blocked plain version, breaks both the share and the
    mean limit (0.401 / 3.36e-3)."""
    cfg = _nano(gt)
    jcfg = _nano(jgwt)
    tp = gt.init_params(cfg, seed=3, compute_dtype=torch.bfloat16,
                        device="cpu")
    jp = jax_init_params(jcfg, seed=3, compute_dtype=jnp.bfloat16)
    mel = (np.random.default_rng(3).standard_normal((1, 4000, 80)) * 0.5
           ).astype(np.float32)
    f_share, f_mean, f_max = _bf16_encoder_gap(tp, cfg, jp, jcfg, mel, 1500)
    calls = []
    orig = A.attention_bh_plain
    monkeypatch.setattr(A, "attention_bh_plain",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or orig(*a, **kw))
    share, mean, mx = _bf16_encoder_gap(tp, cfg, jp, jcfg, mel, 2000)
    assert calls == [(4, 2000, 32)] * cfg.n_audio_layer
    assert share >= f_share - 0.05, (share, f_share)
    assert mean <= 1.15 * f_mean, (mean, f_mean)
    assert mx <= 2 * f_max, (mx, f_max)
    # control: the old CPU route, K13's blocked plain version
    monkeypatch.setattr(tm, "flash_attention_bh",
                        lambda q, k, v, t_valid=None:
                        A.attention_bh_blocked_plain(q, k, v, t_valid))
    c_share, c_mean, _ = _bf16_encoder_gap(tp, cfg, jp, jcfg, mel, 2000)
    assert c_share < f_share - 0.05, (c_share, f_share)
    assert c_mean > 1.15 * f_mean, (c_mean, f_mean)


def _audio(seconds):
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)


def test_full_from_custom_context_file_matches_jax(tmp_path, monkeypatch):
    """A checkpoint whose header says n_audio_ctx 2000 (40 s windows), f32:
    the port's ``full`` through ``from_file`` gives the JAX from_file's
    segments token for token.  Its encoder takes the einsum (the JAX
    package's off-TPU route) once per audio layer and window, and K13's
    plain version never runs inside ``full`` on the CPU."""
    jcfg = _pico(jgwt)
    path = str(tmp_path / "pico-ctx2000.bin")
    export_checkpoint(path, jax_init_params(jcfg, seed=1,
                                            compute_dtype=jnp.float32),
                      jcfg, jmel_filterbank(80), jvocab(jcfg),
                      ttype=jloader.GGML_TYPE_F32)
    jctx = jgwt.WhisperContext.from_file(path, compute_dtype=jnp.float32)
    ctx = gt.WhisperContext.from_file(path, compute_dtype=torch.float32,
                                      device="cpu")
    assert ctx.config.n_audio_ctx == 2000
    calls = {"einsum": 0, "blocked": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(A, "attention_bh_plain",
                        counted("einsum", A.attention_bh_plain))
    monkeypatch.setattr(A, "attention_bh_blocked_plain",
                        counted("blocked", A.attention_bh_blocked_plain))
    audio = _audio(50.0)
    want = jctx.full(jgwt.TranscribeParams(**GREEDY), audio)
    got = ctx.full(gt.TranscribeParams(**GREEDY), audio)

    def view(segs):
        return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]
    assert len(want) > 1
    assert view(got) == view(want)
    assert ctx.timings.n_encode >= 2
    assert calls == {"einsum": ctx.config.n_audio_layer
                     * ctx.timings.n_encode, "blocked": 0}
