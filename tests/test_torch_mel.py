"""Port mel frontend (kernel K1's plain version on the CPU) vs the JAX
package's MelFrontend.device."""

import numpy as np
import pytest
import torch

from godot_whisper_tpu.audio import mel as jax_mel
from godot_whisper_tpu_torch.audio import mel as port_mel
from godot_whisper_tpu_torch.ops import mel_kernel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here: these tests share the CPU with other
    test workers, and oversubscribed intra-op threads slow the many small
    ops of a decode loop by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_audio():
    t = np.arange(5 * 16000) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220.0 * t)
         + 0.2 * np.sin(2 * np.pi * 447.0 * t)
         * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)))
    return x.astype(np.float32)


def test_host_helpers_match():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(port_mel.mel_filterbank(n_mels),
                                      jax_mel.mel_filterbank(n_mels))
    np.testing.assert_array_equal(port_mel.hann_window(),
                                  jax_mel.hann_window())
    x = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    np.testing.assert_array_equal(port_mel.pad_audio(x),
                                  jax_mel.pad_audio(x))
    for n in (0, 150, 16000, 544000):
        assert port_mel.frame_counts(n) == jax_mel.frame_counts(n)
    basis = np.asarray(jax_mel._windowed_dft_basis())
    np.testing.assert_array_equal(mel_kernel.dft_basis()[:, :201],
                                  basis[:, :201])
    np.testing.assert_array_equal(mel_kernel.dft_basis()[:, 201:],
                                  basis[:, 204:405])


@pytest.mark.parametrize("case", ["golden", "random"])
def test_device_mel_matches_jax(case):
    """Same f16-rounded, bucketed audio through both frontends.  Both are
    f32 DFT-as-matmul; they differ only in summation order, so the
    normalized mel agrees to 1e-4 (tests/test_mel.py allows 5e-2 against
    the f64 oracle)."""
    if case == "golden":
        x = _golden_audio()
    else:
        rng = np.random.default_rng(7)
        x = (rng.standard_normal(41000) * 0.2).astype(np.float32)
    filters = jax_mel.mel_filterbank(80)
    want, n_want = jax_mel.MelFrontend(filters).device(x)
    got, n_got = port_mel.MelFrontend(filters, device="cpu").device(x)
    assert n_got == n_want
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_kernel_wrapper_on_cpu_takes_plain_version():
    filters = torch.from_numpy(port_mel.mel_filterbank(80))
    basis = torch.from_numpy(mel_kernel.dft_basis())
    audio = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16000)).astype(np.float16))
    before = mel_kernel.log_mel_raw.launches
    got = mel_kernel.log_mel_raw(audio, basis, filters)
    assert mel_kernel.log_mel_raw.launches == before
    assert tuple(got.shape) == (2, 80, (16000 - 400) // 160 + 1)
    torch.testing.assert_close(
        got, mel_kernel.log_mel_raw_plain(audio, basis, filters))
