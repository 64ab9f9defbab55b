"""The yardstick's counts against hand counts at one small shape."""

import pytest

from gwt_bench import work

CFG = {"d_model": 8, "encoder_attention_heads": 2, "decoder_attention_heads": 2,
       "encoder_layers": 1, "decoder_layers": 1, "encoder_ffn_dim": 32,
       "decoder_ffn_dim": 32, "num_mel_bins": 4, "vocab_size": 10,
       "max_source_positions": 6, "compute_dtype": "bfloat16"}


def test_encoder_attention_counts():
    w = work.encoder_attention(CFG, 2)
    assert w["ops"] == 4 * 6 * 6 * 8 * 2             # QK^T and PV, 2 windows
    assert w["bytes"] == 4 * 6 * 8 * 2 * 2           # q, k, v in, o out


def test_decode_attention_counts():
    w = work.decode_attention(CFG, 1, 2, 3)
    slots = (3 + 4 + 5) + 6 * 3                      # self live + audio
    assert w["ops"] == 4 * slots * 8
    assert w["bytes"] == 2 * slots * 8 * 2 + 2 * 3 * (8 * 2 + 8 * 4)


def test_model_ops():
    stem = 2 * 12 * 12 * 8 + 2 * 6 * 24 * 8
    layer = 2 * 6 * 4 * 64 + 2 * 6 * 2 * 8 * 32 + 4 * 36 * 8
    assert work.encoder_ops(CFG) == stem + layer
    assert work.cross_kv_ops(CFG) == 2 * 6 * 2 * 64
    tok = 2 * 6 * 64 + 2 * 2 * 8 * 32 + 4 * 5 * 8 + 4 * 6 * 8
    assert work.decoder_token_ops(CFG, 5) == tok
    assert work.logits_ops(CFG) == 2 * 8 * 10
    prompt, n = 2, 3
    want = (work.encoder_ops(CFG) + work.cross_kv_ops(CFG)
            + work.decoder_token_ops(CFG, 1) + work.decoder_token_ops(CFG, 2)
            + work.logits_ops(CFG)
            + work.decoder_token_ops(CFG, 3) + work.decoder_token_ops(CFG, 4)
            + 2 * work.logits_ops(CFG))
    assert work.serve_window_ops(CFG, prompt, n) == want
    assert work.train_row_forward_ops(CFG, 2) == (
        work.encoder_ops(CFG) + work.cross_kv_ops(CFG)
        + work.decoder_token_ops(CFG, 1) + work.decoder_token_ops(CFG, 2)
        + 2 * work.logits_ops(CFG))


def test_bound_takes_the_larger_side():
    assert work.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert work.bound_s(67e12, 3.35e12 / 2, "float32") == pytest.approx(1.0)
