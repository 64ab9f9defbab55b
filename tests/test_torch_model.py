"""Port forward passes vs the JAX package's at f32 on the nano config:
encoder, cross-KV, the dense prompt pass and the cached decode step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_whisper_tpu.models import model as jm
from godot_whisper_tpu.models.params import init_params as jax_init_params
from godot_whisper_tpu_torch.models import model as tm
from godot_whisper_tpu_torch.models.config import get_config
from godot_whisper_tpu_torch.models.params import init_params

# tests/test_model.py holds the JAX encoder and step to atol 2e-4 against
# their references; the same f32 math in another summation order here
ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here: these tests share the CPU with other
    test workers, and oversubscribed intra-op threads slow the many small
    ops of a decode loop by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nano():
    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128,
        n_audio_head=4, n_text_state=128, n_text_head=4, name="nano")
    return (cfg, init_params(cfg, seed=3, compute_dtype=torch.float32,
                             device="cpu"),
            jax_init_params(cfg, seed=3, compute_dtype=jnp.float32))


@pytest.fixture(scope="module")
def encoded(nano):
    cfg, tp, jp = nano
    mel = np.random.default_rng(0).standard_normal(
        (1, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)
    enc_t = tm.encoder_forward(tp, cfg, torch.from_numpy(mel))
    enc_j = jm.encoder_forward(jp, cfg, jnp.asarray(mel))
    return enc_t, enc_j, tm.cross_kv(tp, cfg, enc_t), jm.cross_kv(jp, cfg,
                                                                   enc_j)


def test_encoder_matches_jax(encoded):
    enc_t, enc_j, _, _ = encoded
    assert tuple(enc_t.shape) == enc_j.shape
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=ATOL,
                               rtol=0)


def test_reduced_audio_ctx_matches_jax(nano):
    cfg, tp, jp = nano
    mel = np.random.default_rng(2).standard_normal(
        (2, 2 * 200, cfg.n_mels)).astype(np.float32)
    got = tm.encoder_forward(tp, cfg, torch.from_numpy(mel), audio_ctx=200)
    want = jm.encoder_forward(jp, cfg, jnp.asarray(mel), audio_ctx=200)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_cross_kv_matches_jax(encoded):
    _, _, x_t, x_j = encoded
    assert x_t.t_valid == int(x_j.t_valid) == 1500
    assert tuple(x_t.k.shape) == x_j.k.shape == (2, 1, 1536, 128)
    np.testing.assert_allclose(x_t.k.numpy(), np.asarray(x_j.k), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(x_t.v.numpy(), np.asarray(x_j.v), atol=ATOL,
                               rtol=0)


def _prompt(cfg, B, P):
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.token_eot, (B, P)).astype(np.int32)
    n_valid = np.asarray([P, P - 3][:B], np.int32)
    return toks, n_valid


def test_decoder_dense_matches_jax(nano, encoded):
    cfg, tp, jp = nano
    _, _, x_t, x_j = encoded
    B, P = 2, 8
    toks, n_valid = _prompt(cfg, B, P)
    xk_t = tm.CrossKV(x_t.k.expand(-1, B, -1, -1), x_t.v.expand(
        -1, B, -1, -1), x_t.t_valid)
    xk_j = jm.CrossKV(jnp.broadcast_to(x_j.k, (2, B, 1536, 128)),
                      jnp.broadcast_to(x_j.v, (2, B, 1536, 128)),
                      x_j.t_valid)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P))
    kv_t = tm.init_kv_cache(cfg, B, cache_len=P + 16, dtype=torch.float32,
                            device="cpu")
    kv_j = jm.init_kv_cache(cfg, B, cache_len=P + 16, dtype=jnp.float32)
    got, kv_t = tm.decoder_dense(tp, cfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos.copy()), kv_t, xk_t,
                                 n_valid=torch.from_numpy(n_valid))
    want, kv_j = jm.decoder_dense(jp, cfg, jnp.asarray(toks),
                                  jnp.asarray(pos), kv_j, xk_j,
                                  n_valid=jnp.asarray(n_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(kv_t.k.numpy(), np.asarray(kv_j.k),
                               atol=ATOL, rtol=0)


def test_decoder_step_matches_jax_and_dense(nano, encoded):
    """Token by token through the cache (kernel K3/K4's plain version on
    the CPU) equals the dense pass and the JAX step, with a masked gap
    between the per-row prompt and the uniform decode slots and cross-KV
    shared by a group of 2 rows."""
    cfg, tp, jp = nano
    _, _, x_t, x_j = encoded
    B, P, split = 2, 5, 8
    toks, _ = _prompt(cfg, B, P + 4)
    n_prompt = np.asarray([P, P - 2], np.int32)
    # dense reference: each row's prompt then its decode tokens, contiguous
    ref = []
    for b in range(B):
        row = np.concatenate([toks[b, :n_prompt[b]], toks[b, P:P + 4]])
        kv = tm.init_kv_cache(cfg, 1, cache_len=32, dtype=torch.float32,
                              device="cpu")
        lg, _ = tm.decoder_dense(
            tp, cfg, torch.from_numpy(row[None]),
            torch.arange(len(row), dtype=torch.int32)[None], kv,
            tm.CrossKV(x_t.k, x_t.v, x_t.t_valid),
            n_valid=torch.tensor([len(row)]))
        ref.append(lg[0, n_prompt[b] - 1:].numpy())

    prompt = np.zeros((B, split), np.int32)
    for b in range(B):
        prompt[b, :n_prompt[b]] = toks[b, :n_prompt[b]]
    pos = np.broadcast_to(np.arange(split, dtype=np.int32), (B, split))
    xk_t = tm.CrossKV(x_t.k.expand(-1, B, -1, -1).contiguous(),
                      x_t.v.expand(-1, B, -1, -1).contiguous(), x_t.t_valid)
    kv_t = tm.init_kv_cache(cfg, B, cache_len=split + 8,
                            dtype=torch.float32, device="cpu")
    kv_j = jm.init_kv_cache(cfg, B, cache_len=split + 8, dtype=jnp.float32)
    lg_t, kv_t = tm.decoder_dense(
        tp, cfg, torch.from_numpy(prompt), torch.from_numpy(pos.copy()),
        kv_t, xk_t, n_valid=torch.from_numpy(n_prompt),
        logit_rows=torch.from_numpy(n_prompt - 1))
    _, kv_j = jm.decoder_dense(
        jp, cfg, jnp.asarray(prompt), jnp.asarray(pos), kv_j,
        jm.CrossKV(jnp.broadcast_to(x_j.k, (2, B, 1536, 128)),
                   jnp.broadcast_to(x_j.v, (2, B, 1536, 128)), x_j.t_valid),
        n_valid=jnp.asarray(n_prompt))
    steps = [lg_t[:, 0].numpy()]
    lo = torch.from_numpy(n_prompt)
    for i in range(4):
        tok = toks[:, P + i]
        lg_t, kv_t = tm.decoder_step(
            tp, cfg, torch.from_numpy(tok), torch.from_numpy(n_prompt + i),
            kv_t, tm.CrossKV(x_t.k, x_t.v, x_t.t_valid), lo=lo,
            slot=split + i, split=split, kv_group=2)
        lg_j, kv_j = jm.decoder_step(
            jp, cfg, jnp.asarray(tok), jnp.asarray(n_prompt + i), kv_j,
            x_j, lo=jnp.asarray(n_prompt), slot=jnp.int32(split + i),
            split=split, kv_group=2)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                   atol=ATOL, rtol=0)
        steps.append(lg_t.numpy())
    steps = np.stack(steps, axis=1)                        # (B, 5, V)
    for b in range(B):
        np.testing.assert_allclose(steps[b], ref[b], atol=ATOL, rtol=0)


def test_bf16_conv_stem_matches_compiled_jax():
    """The conv stem's rounding points are those of the JAX package's
    jitted window encode: XLA keeps each convolution's f32 sum for the GELU
    that reads it.  The port's stem (``conv_stem``, f32 sums of the bf16
    values) agrees with the compiled JAX stem in all but a few elements
    (f32 sums in another order: 51 of 192000 on this input); the stem that
    rounds each conv output to bf16 first differs in about half."""
    import jax

    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=3, n_audio_state=128,
        n_audio_head=4, n_text_state=128, n_text_head=4, name="nano-3")
    tp = init_params(cfg, seed=3, compute_dtype=torch.bfloat16,
                     device="cpu")
    jp = jax_init_params(cfg, seed=3, compute_dtype=jnp.bfloat16)
    mel = (np.random.default_rng(0).standard_normal((1, 3000, 80)) * 0.5
           ).astype(np.float32)

    @jax.jit
    def jax_stem(enc, w):   # models/model.py encoder_forward's stem lines
        dn = ("NWC", "WIO", "NWC")
        y = jax.lax.conv_general_dilated(w.astype(jnp.bfloat16),
                                         enc["conv1"]["w"], (1,), [(1, 1)],
                                         dimension_numbers=dn)
        y = jax.nn.gelu(y.astype(jnp.float32) + enc["conv1"]["b"],
                        approximate=False).astype(jnp.bfloat16)
        y = jax.lax.conv_general_dilated(y, enc["conv2"]["w"], (2,),
                                         [(1, 1)], dimension_numbers=dn)
        y = jax.nn.gelu(y.astype(jnp.float32) + enc["conv2"]["b"],
                        approximate=False)
        return (y + enc["pos_embed"][:1500]).astype(jnp.bfloat16)

    want = np.asarray(jax_stem(jp["encoder"], jnp.asarray(mel))
                      .astype(jnp.float32))
    enc = tp["encoder"]

    def port(stem):
        return (stem + enc["pos_embed"][:1500]).to(torch.bfloat16).float()

    got = port(tm.conv_stem(enc, torch.from_numpy(mel))).numpy()
    # control: the conv output rounded to bf16 before each GELU
    x = torch.nn.functional.conv1d(
        torch.from_numpy(mel).to(torch.bfloat16).transpose(1, 2),
        enc["conv1"]["w"], padding=1)
    x = tm._gelu(x.float() + enc["conv1"]["b"][:, None]).to(torch.bfloat16)
    x = torch.nn.functional.conv1d(x, enc["conv2"]["w"], stride=2,
                                   padding=1)
    rounded = port(tm._gelu(x.float() + enc["conv2"]["b"][:, None])
                   .transpose(1, 2)).numpy()
    assert got.shape == want.shape
    assert (got != want).mean() < 1e-3
    assert (rounded != want).mean() > 0.1
