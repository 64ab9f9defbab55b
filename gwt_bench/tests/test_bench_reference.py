"""The plain reference against the program on the CPU at nano size, both
in float32: the filterbank, the log-mel, the encoder, the teacher-forced
logits, the loss and its gradients, one AdamW step."""

import numpy as np
import pytest
import torch

from gwt_bench import reference, specs, weights
from gwt_bench.entries import port_config
from gwt_bench.traffic import pool_pcm


@pytest.fixture(scope="module")
def nano(request):
    from gwt_bench.tests.conftest import DATA
    cfg = specs.config("nano-f32", [DATA])
    return cfg, port_config(cfg), weights.draw(cfg, 42, "cpu")


def test_filterbank_and_log_mel_match_the_program():
    from godot_whisper_tpu_torch.audio.mel import log_mel_np, mel_filterbank
    fb = reference.slaney_filterbank(80)
    np.testing.assert_allclose(fb, mel_filterbank(80), rtol=1e-5, atol=1e-8)
    pcm = pool_pcm(3.0, 5, "cpu")
    got = reference.log_mel(pcm, fb, "cpu").numpy()
    want = log_mel_np(pcm, fb)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_forward_matches_the_program(nano):
    from godot_whisper_tpu_torch.models.model import (cross_kv, decoder_dense,
                                                      encoder_forward,
                                                      init_kv_cache)
    cfg, wcfg, params = nano
    torch.manual_seed(0)
    mel = torch.randn(2, 80, 3000)
    tokens = torch.randint(0, 50257, (2, 7))
    ref = reference.Reference(params, cfg)
    with torch.no_grad():
        enc_r = ref.encode(mel)
        logits_r = ref.logits(enc_r, tokens)
        enc_p = encoder_forward(params, wcfg, mel.transpose(1, 2))
        kv = init_kv_cache(wcfg, 2, dtype=torch.float32, device="cpu")
        pos = torch.arange(7, dtype=torch.int32).expand(2, 7)
        logits_p, _ = decoder_dense(params, wcfg, tokens, pos, kv,
                                    cross_kv(params, wcfg, enc_p),
                                    n_valid=torch.full((2,), 7))
    torch.testing.assert_close(enc_r, enc_p.float(), atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(logits_r, logits_p, atol=2e-4, rtol=1e-4)


def test_loss_gradients_and_adamw_match_the_program(nano):
    from godot_whisper_tpu_torch.models import training
    cfg, wcfg, params = nano
    g = torch.Generator().manual_seed(1)
    mel = torch.randn(3, 80, 3000, generator=g)
    tokens = torch.randint(0, 50257, (3, 6), generator=g)
    targets = torch.randint(0, 50257, (3, 6), generator=g)
    mask = torch.ones(3, 6)
    mask[2, 4:] = 0
    flat = {k: v.detach() for k, v in reference.flatten(params).items()}
    loss_r, grads_r = reference.loss_and_grads(flat, cfg, "f32", mel, tokens,
                                               targets, mask, rows=2)
    loss_p, grads_p = training.loss_and_grads(
        params, wcfg, {"mel": mel.transpose(1, 2).contiguous(),
                       "tokens": tokens, "targets": targets, "mask": mask},
        device="cpu")
    assert float(loss_r) == pytest.approx(float(loss_p), rel=1e-5)
    gp = reference.flatten(grads_p)
    for k, v in grads_r.items():
        torch.testing.assert_close(v, gp[k], atol=1e-5 * float(
            v.abs().max()) + 1e-9, rtol=1e-3)
    opt = training.make_optimizer(1e-3, 0.01)
    up, _ = opt.update(grads_p, opt.init(params), params)
    new_p = reference.flatten(training.apply_updates(params, up))
    ref_opt = reference.AdamW(1e-3, 0.01)
    new_r, _ = ref_opt.step(flat, gp, ref_opt.init(flat))   # same grads
    for k in flat:
        torch.testing.assert_close(new_r[k], new_p[k], atol=1e-6, rtol=1e-5)
