"""The long audio context (n_audio_ctx > 1536) in the port against the JAX
package on the CPU: K13's plain version against the TPU kernel
``_flash_kernel`` in interpret mode, the encoder at n_audio_ctx 2000
against the JAX encoder in interpret mode (pad-native, K13), and ``full``
from a custom-context ggml file token for token."""

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


def _pico(pkg, n_audio_ctx=2000, n_text_layer=3):
    return pkg.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=n_text_layer, n_audio_state=64,
        n_audio_head=2, n_text_state=64, n_text_head=2,
        n_audio_ctx=n_audio_ctx, name="pico")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,d", [(2, 1600, 64), (2, 2048, 32)])
def test_blocked_plain_matches_jax_k13(interpret, dtype, bh, t, d):
    """T = 1600 pads to 2048 > 1536, so both packages route to the blocked
    kernel (K13): f32 within 2e-4 (tests/test_ops.py); bf16 within one
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
    got = A.flash_attention_bh(qt, kt, vt)
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
    (interpret mode); the port's CPU encoder runs the blocked plain version
    at T 2000.  f32, within tests/test_model.py's 2e-4."""
    cfg = _pico(gt)
    jcfg = _pico(jgwt)
    tp = gt.init_params(cfg, seed=2, compute_dtype=torch.float32,
                        device="cpu")
    jp = jax_init_params(jcfg, seed=2, compute_dtype=jnp.float32)
    mel = np.random.default_rng(0).standard_normal(
        (1, 4000, 80)).astype(np.float32)
    calls = []
    orig = A.attention_bh_blocked_plain
    monkeypatch.setattr(A, "attention_bh_blocked_plain",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or orig(*a, **kw))
    got = tm.encoder_forward(tp, cfg, torch.from_numpy(mel)).numpy()
    assert calls == [(2, 2000, 32)]
    want = np.asarray(jax.jit(lambda p, x: jm.encoder_forward(p, jcfg, x))(
        jp, jnp.asarray(mel)))
    assert got.shape == want.shape == (1, 2000, 64)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def _audio(seconds):
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)


def test_full_from_custom_context_file_matches_jax(tmp_path, monkeypatch):
    """A checkpoint whose header says n_audio_ctx 2000 (40 s windows), f32:
    the port's ``full`` through ``from_file`` gives the JAX from_file's
    segments token for token, and its encoder goes through K13's route
    once per audio layer and window."""
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
    calls = []
    orig = A.attention_bh_blocked_plain
    monkeypatch.setattr(A, "attention_bh_blocked_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    audio = _audio(50.0)
    want = jctx.full(jgwt.TranscribeParams(**GREEDY), audio)
    got = ctx.full(gt.TranscribeParams(**GREEDY), audio)

    def view(segs):
        return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]
    assert len(want) > 1
    assert view(got) == view(want)
    assert ctx.timings.n_encode >= 2
    assert len(calls) == ctx.config.n_audio_layer * ctx.timings.n_encode
