"""The port's quantized kernels K9-K12 held against the JAX package through
their plain PyTorch versions on the CPU, with the JAX side run as its own
suite runs it (Pallas in interpret mode, tests/test_qmatmul.py and
tests/test_ops.py): the int8 / int4 quantizers bit for bit, K9/K10
(``quant_matmul`` / ``quant_matmul4``) within 1e-4, K11/K12
(``cross_attention_quant``) in exact and W8A8 mode.  The CUDA kernels are
held against the plain versions on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_whisper_tpu.ops import cross_attention as jca
from godot_whisper_tpu.ops import qmatmul as jq
from godot_whisper_tpu_torch.models.model import _layer
from godot_whisper_tpu_torch.ops import cross_attention as CA
from godot_whisper_tpu_torch.ops import qmatmul as Q

# the JAX suite's limit for its kernels against their CPU branches
ATOL_QMM = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: these tests share the CPU with other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bf16_t(a_jax):
    """A JAX bf16 array as a torch bf16 tensor with the same bits."""
    return _t(np.asarray(a_jax.astype(jnp.float32))).to(torch.bfloat16)


# ------------------------------------------------------------ quantizers --
@pytest.mark.parametrize("shape,axis", [((96, 200), 0), ((200, 96), 1),
                                        ((3, 128, 200), 1)])
def test_quantize_tensor_bit_equal(rng, shape, axis):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                     # an all-zero column (scale clamp)
    want = jq.quantize_tensor(jnp.asarray(w), reduce_axis=axis)
    got = Q.quantize_tensor(_t(w), reduce_axis=axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    assert Q.reduced_axis(got) == jq.reduced_axis(want)
    np.testing.assert_array_equal(Q.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))


@pytest.mark.parametrize("shape,group", [((256, 200), 128), ((2, 384, 64), 128),
                                         ((128, 96), 64)])
def test_quantize_tensor4_bit_equal(rng, shape, group):
    w = rng.standard_normal(shape).astype(np.float32)
    want = jq.quantize_tensor4(jnp.asarray(w), group=group)
    got = Q.quantize_tensor4(_t(w), group=group)
    assert got.q.dtype == torch.uint8 and got.group == want.group == group
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_array_equal(Q.dequantize4(got).numpy(),
                                  np.asarray(jq.dequantize4(want)))


def test_layer_accessor_slices_quant_leaves(rng):
    """A quant container's [i] is tuple indexing; the per-layer slicers
    take layer li of q and s instead."""
    w = rng.standard_normal((3, 128, 64)).astype(np.float32)
    q8 = Q.quantize_tensor(_t(w), reduce_axis=1)
    q4 = Q.quantize_tensor4(_t(w))
    layer = _layer({"mlp": {"w8": q8, "w4": q4, "b": _t(w[:, 0])}}, 1)["mlp"]
    assert isinstance(layer["w8"], Q.QuantTensor)
    assert torch.equal(layer["w8"].q, q8.q[1])
    assert torch.equal(layer["w8"].s, q8.s[1])
    assert isinstance(layer["w4"], Q.Quant4Tensor)
    assert torch.equal(layer["w4"].q, q4.q[1])
    assert torch.equal(layer["b"], _t(w[1, 0]))


# -------------------------------------------------------------- K9 / K10 --
@pytest.mark.parametrize("layout,wshape,m", [("io", (96, 200), 5),
                                             ("oi", (200, 96), 5),
                                             ("io", (128, 200), 40),
                                             ("oi", (200, 128), 1)])
def test_quant_matmul_plain_matches_tpu_kernel(rng, layout, wshape, m):
    """K9's plain version vs ``_qmm_kernel`` in interpret mode: a ragged
    output dim (200), decode-sized and prompt-sized row counts."""
    x = rng.standard_normal((m, wshape[0] if layout == "io" else wshape[1])
                            ).astype(np.float32)
    w = rng.standard_normal(wshape).astype(np.float32)
    qt = jq.quantize_tensor(jnp.asarray(w),
                            reduce_axis=0 if layout == "io" else 1)
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), qt, layout=layout,
                                      interpret=True))
    got = Q.quant_matmul(_t(x), Q.QuantTensor(_t(qt.q), _t(qt.s)),
                         layout=layout)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_QMM, rtol=0)


def test_quant_matmul_leading_dims_match_jax(rng):
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    qt = jq.quantize_tensor(jnp.asarray(w), reduce_axis=0)
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), qt, layout="io"))
    got = Q.quant_matmul(_t(x), Q.QuantTensor(_t(qt.q), _t(qt.s)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_QMM, rtol=0)


@pytest.mark.parametrize("s_in,m", [(256, 5), (384, 5), (256, 33),
                                    (128, 16), (128, 17)])
def test_quant_matmul4_plain_matches_tpu_kernel(rng, s_in, m):
    """K10's plain version vs ``_q4mm_kernel`` in interpret mode: O = 200,
    one, two and three groups of 128; 16 and 17 rows are the two sides of
    the card's route boundary (decode rows, tensor-core tiles)."""
    x = rng.standard_normal((m, s_in)).astype(np.float32)
    w = rng.standard_normal((s_in, 200)).astype(np.float32)
    qt = jq.quantize_tensor4(jnp.asarray(w), group=128)
    want = np.asarray(jq.quant_matmul4(jnp.asarray(x), qt, interpret=True))
    got = Q.quant_matmul4(_t(x), Q.Quant4Tensor(_t(qt.q), _t(qt.s)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_QMM, rtol=0)
    # and the JAX CPU branch (per-group einsum)
    cpu = np.asarray(jq.quant_matmul4(jnp.asarray(x), qt))
    np.testing.assert_allclose(got.numpy(), cpu, atol=ATOL_QMM, rtol=0)


# -------------------------------------------------------------- K11 / K12 --
def _quant_kv(rng, g, t, n_head, d):
    """Merged-layout int8 K/V with padded scales, as tests/test_ops.py
    makes them."""
    s = n_head * d
    kf = rng.standard_normal((g, t, n_head, d)).astype(np.float32)
    vf = rng.standard_normal((g, t, n_head, d)).astype(np.float32)
    k_s = np.abs(kf).max(-1) / 127.0 + 1e-9
    k_q = np.clip(np.round(kf / k_s[..., None]), -127, 127).astype(
        np.int8).reshape(g, t, s)
    v_s = np.abs(vf).max(axis=(1, 3)) / 127.0 + 1e-9
    v_q = np.clip(np.round(vf / v_s[:, None, :, None]), -127, 127).astype(
        np.int8).reshape(g, t, s)
    ksp = np.zeros((g, t, 128), np.float32)
    ksp[..., :n_head] = k_s
    vsp = np.zeros((g, 128), np.float32)
    vsp[:, :n_head] = v_s
    return k_q, jnp.asarray(ksp).astype(jnp.bfloat16), v_q, vsp


def _oracle(q, k_q, k_s, v_q, v_s, n_head, t_valid, kv_group):
    """Float64 softmax over the dequantized K/V (tests/test_ops.py's)."""
    b, s = q.shape
    d = s // n_head
    out = np.zeros((b, s))
    for r in range(b):
        g = r // kv_group
        for h in range(n_head):
            sl = slice(h * d, (h + 1) * d)
            kf = k_q[g, :t_valid, sl] * k_s[g, :t_valid, h][:, None]
            vf = v_q[g, :t_valid, sl] * float(v_s[g, h])
            sc = kf.astype(np.float64) @ q[r, sl].astype(np.float64) \
                / np.sqrt(d)
            p = np.exp(sc - sc.max())
            out[r, sl] = (p / p.sum()) @ vf
    return out


XATTN_CASES = [
    # (kv_group, n_head, head_dim, T_pad, t_valid, L, layer): K12 greedy
    # (kv_group 1) and best_of / beam groups of 5 with blocks of 512 and of
    # 256; the wide K11 route (5 x 32 heads > 128; large-v3's 20 heads at
    # beam 8 and 7); a stacked L = 3 cache
    (1, 6, 64, 512, 300, 1, 0),
    (5, 6, 64, 512, 300, 1, 0),
    (5, 6, 64, 256, 200, 1, 0),
    (5, 32, 16, 256, 100, 1, 0),
    (5, 6, 64, 512, 300, 3, 1),
    (8, 20, 64, 512, 389, 1, 0),
    (7, 20, 64, 512, 300, 1, 0),
]


@pytest.mark.parametrize("w8a8", [False, True], ids=["exact", "w8a8"])
@pytest.mark.parametrize("kg,H,D,T,tv,L,layer", XATTN_CASES)
def test_cross_attention_quant_plain_matches_tpu_kernels(
        monkeypatch, w8a8, kg, H, D, T, tv, L, layer):
    """The plain version vs ``_xattn_q_group_packed_kernel`` /
    ``_xattn_q_kernel`` in interpret mode, t_valid not a block multiple.

    Exact mode: 1e-4 (f32 sums in another order).  W8A8 (packed only; the
    wide route has no W8A8 mode): probabilities are rounded to integers
    round(127 p), and exp() from another library may flip one rounding; a
    flip moves P.V by at most max|v_q| = 127 units, i.e. the output of that
    (row, head) by 127 / 127 * v_s[h] / l, with l the softmax denominator.
    The limit allows one flip per (row, head) on top of 1e-4
    (``w8a8_flip_limit``)."""
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(11)
    G = 2
    B, S = G * kg, H * D
    q = rng.standard_normal((B, S)).astype(np.float32)
    layers = [_quant_kv(rng, G, T, H, D) for _ in range(L)]
    k_q = np.stack([x[0] for x in layers])
    k_s = jnp.stack([x[1] for x in layers])
    v_q = np.stack([x[2] for x in layers])
    v_s = np.stack([x[3] for x in layers])
    tvec = np.full((B,), tv, np.int32)
    want = np.asarray(jca.cross_attention_quant(
        jnp.asarray(q), jnp.asarray(k_q), k_s, jnp.asarray(v_q),
        jnp.asarray(v_s), n_head=H, t_valid=jnp.asarray(tvec), kv_group=kg,
        layer=jnp.int32(layer), interpret=True, w8a8=w8a8))
    got = CA.cross_attention_quant(
        _t(q), _t(k_q), _bf16_t(k_s), _t(v_q), _t(v_s), n_head=H,
        t_valid=_t(tvec), kv_group=kg, layer=layer, w8a8=w8a8).numpy()
    err = np.abs(got - want)
    if w8a8 and CA.is_packed(H, kg):
        tol = 1e-4 + CA.w8a8_flip_limit(
            _t(q), _t(k_q), _bf16_t(k_s), _t(v_s), _t(tvec), n_head=H,
            kv_group=kg, layer=layer).numpy()
        assert (err <= tol).all(), float((err / tol).max())
    else:
        assert err.max() < 1e-4, err.max()


@pytest.mark.parametrize("w8a8", [False, True], ids=["exact", "w8a8"])
@pytest.mark.parametrize("kg,H,D,T,tv", [(1, 6, 64, 512, 300),
                                         (5, 6, 64, 256, 200),
                                         (5, 32, 16, 256, 100)])
def test_cross_attention_quant_plain_matches_float_oracle(w8a8, kg, H, D, T,
                                                          tv):
    """The JAX suite's float oracle and limits (tests/test_ops.py): 2e-2
    exact, 3e-2 W8A8 (activation quantization on top of bf16 scales)."""
    rng = np.random.default_rng(7)
    G = 2
    B, S = G * kg, H * D
    q = rng.standard_normal((B, S)).astype(np.float32)
    k_q, k_s, v_q, v_s = _quant_kv(rng, G, T, H, D)
    got = CA.cross_attention_quant(
        _t(q), _t(k_q)[None], _bf16_t(k_s)[None], _t(v_q)[None],
        _t(v_s)[None], n_head=H,
        t_valid=torch.full((B,), tv, dtype=torch.int32), kv_group=kg,
        w8a8=w8a8).numpy()
    want = _oracle(q, k_q.astype(np.float64),
                      np.asarray(k_s.astype(jnp.float32)),
                      v_q.astype(np.float64), v_s, H, tv, kg)
    tol = 3e-2 if w8a8 else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_w8a8_default_reads_the_exact_switch(monkeypatch):
    monkeypatch.delenv("GWT_XATTN_EXACT", raising=False)
    assert CA.w8a8_default() and jca.w8a8_default()
    monkeypatch.setenv("GWT_XATTN_EXACT", "1")
    assert not CA.w8a8_default() and not jca.w8a8_default()


def test_quant_wrappers_take_the_kernel_path_off_the_cpu():
    """Only CPU tensors take the plain versions; a tensor on another device
    goes to the kernel path, which checks it and raises (the meta device
    stands in for a device without the kernel)."""
    x = torch.empty(5, 128, device="meta")
    qt = Q.QuantTensor(torch.empty(128, 64, dtype=torch.int8, device="meta"),
                       torch.empty(64, device="meta"))
    with pytest.raises(ValueError):
        Q.quant_matmul(x, qt)
    q4 = Q.Quant4Tensor(torch.empty(64, 64, dtype=torch.uint8, device="meta"),
                        torch.empty(1, 64, device="meta"))
    with pytest.raises(ValueError):
        Q.quant_matmul4(x, q4)
    kq = torch.empty(1, 1, 256, 128, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        CA.cross_attention_quant(
            x[:1], kq, torch.empty(1, 1, 256, 128, dtype=torch.bfloat16,
                                   device="meta"),
            kq, torch.empty(1, 1, 128, device="meta"), n_head=2,
            t_valid=torch.full((1,), 200, dtype=torch.int32, device="meta"))
