"""Port mel frontend (kernel K1's plain version on the CPU) vs the JAX
package's MelFrontend.device, and K1's split-TF32 numerics modelled on the
CPU: its fragment-ordered basis and split, its filterbank runs, and a torch
model of its arithmetic against the f64 result and the TPU kernel."""

import numpy as np
import pytest
import torch

from chip_smoke import (CountingSpan, host_padded_stack, mel_f64,
                        mel_limit, mel_tf32_one_pass, tf32_round)
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
    tables = mel_kernel.mel_tables(basis, filters)
    # the CPU route never reads the kernel's tables, so none are built
    assert (tables.frag_basis, tables.runs, tables.weights) == (None,) * 3
    before = mel_kernel.log_mel_raw.launches
    got = mel_kernel.log_mel_raw(audio, tables)
    assert mel_kernel.log_mel_raw.launches == before
    assert tuple(got.shape) == (2, 80, (16000 - 400) // 160 + 1)
    torch.testing.assert_close(
        got, mel_kernel.log_mel_raw_plain(audio, basis, filters))


def _frag_index():
    """(n, bin, is_sin) of every entry of ``frag_basis``'s (50, 26, 32, 4)
    layout: lane // 4 is the bin within the tile, lane % 4 + 4 (j // 2)
    the sample within the k-step, odd j the -sin rows."""
    ks, bt, lane, j = np.meshgrid(np.arange(50), np.arange(26),
                                  np.arange(32), np.arange(4), indexing="ij")
    return 8 * ks + lane % 4 + 4 * (j // 2), 8 * bt + lane // 4, j % 2


def test_frag_basis_split_reconstructs_dft_basis():
    """The kernel's basis holds every value of ``dft_basis()`` in fragment
    order (bins 201-207 zero); hi = tf32(b), lo = tf32(b - hi) (the
    kernel's rounding, to nearest with ties away) reconstruct it within
    2^-21 relative; every finite f16 sample is exact in TF32, so the audio
    needs no split."""
    basis = mel_kernel.dft_basis()
    frag = mel_kernel.frag_basis(basis)
    assert frag.shape == (50, 26, 32, 4) and frag.dtype == np.float32
    n, k, is_sin = _frag_index()
    live = k < 201
    want = basis[n[live], k[live] + 201 * is_sin[live]]
    np.testing.assert_array_equal(frag[live], want)
    assert not frag[~live].any()
    b = torch.from_numpy(frag)
    hi = tf32_round(torch, b)
    lo = tf32_round(torch, b - hi)
    err = (hi.double() + lo.double() - b.double()).abs()
    assert bool((err <= 2.0 ** -21 * b.double().abs()).all())
    assert float((hi.double() - b.double()).abs().max()) > 1e-6  # split
    h = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    f16 = h.view(torch.float16).float()
    f16 = f16[torch.isfinite(f16)]
    assert torch.equal(tf32_round(torch, f16), f16)


def _bin_order_sum(power, filters, runs=None):
    """(F, n_mels): each mel's sum over bins in bin order, f32 multiply then
    add (csrc/mel.cu's arithmetic); over all 201 bins, or over the run."""
    out = torch.zeros(power.shape[0], filters.shape[0])
    for m in range(filters.shape[0]):
        ks = range(201) if runs is None else range(runs[m, 0],
                                                   runs[m, 1] + 1)
        acc = torch.zeros(power.shape[0])
        for k in ks:
            acc = acc + power[:, k] * filters[m, k]
        out[:, m] = acc
    return out


@pytest.mark.parametrize("case", ["slaney80", "slaney128", "ragged"])
def test_mel_runs_cover_filterbank(case):
    """Every nonzero of a filterbank lies in its mel's run (first to last
    nonzero bin), whose weights sit packed at the run's offset; an all-zero
    row gets an empty run; the sum over the runs in bin order equals the
    dense sum in bin order bit for bit."""
    if case == "ragged":
        rng = np.random.default_rng(3)
        filters = (rng.random((6, 201)) * (rng.random((6, 201)) < 0.2)
                   ).astype(np.float32)
        filters[2] = 0.0
        filters[4, 5:190] = rng.random(185)
        filters[4, 60:70] = 0.0
    else:
        filters = port_mel.mel_filterbank(int(case[6:]))
    runs, weights = mel_kernel.mel_runs(filters)
    assert runs.dtype == np.int32 and runs.shape == (len(filters), 3)
    for m, row in enumerate(filters):
        nz = np.flatnonzero(row)
        k0, k1, off = runs[m]
        if nz.size == 0:
            assert k1 < k0
        else:
            assert (k0, k1) == (nz[0], nz[-1])
            np.testing.assert_array_equal(weights[off:off + k1 - k0 + 1],
                                          row[k0:k1 + 1])
    if case == "slaney80":
        assert int((filters != 0).sum()) == 391
        assert int((runs[:, 1] - runs[:, 0] + 1).max()) <= 14
    power = torch.from_numpy(np.random.default_rng(4).random(
        (64, 201)).astype(np.float32) * 1e3)
    f = torch.from_numpy(filters)
    assert torch.equal(_bin_order_sum(power, f, runs),
                       _bin_order_sum(power, f))


def _split_tf32_model(a16, basis, filters):
    """K1's arithmetic modelled in torch on the CPU: the DFT k step by k
    step (8 samples), x.hi + x.lo with the basis split by tf32 rounding,
    added to the running f32 sum; power re re + im im, the runs summed in
    bin order, log10(max(x, 1e-10)).  (The tensor cores sum the products
    of a k step in their own order, truncating.)"""
    frames = a16.float().unfold(-1, 400, 160)
    hi = tf32_round(torch, basis)
    lo = tf32_round(torch, basis - hi)
    spec = torch.zeros(*frames.shape[:-1], 402)
    for ks in range(50):
        x = frames[..., 8 * ks:8 * ks + 8]
        spec = spec + (x @ hi[8 * ks:8 * ks + 8] + x @ lo[8 * ks:8 * ks + 8])
    re, im = spec[..., :201], spec[..., 201:]
    power = re * re + im * im
    runs, _ = mel_kernel.mel_runs(filters.numpy())
    mel = torch.stack([_bin_order_sum(p, filters, runs) for p in power])
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_split_tf32_model_within_limit(n_mels, monkeypatch):
    """The model of K1's split-TF32 arithmetic stays within ``mel_limit``
    (1.5x the plain f32 version's error against the f64 result, at least
    1e-4 log10) of the f64 result and of the TPU kernel (``log_mel_pallas``
    in interpret mode, normalized: compared as 4x the difference of the
    normalized mels, i.e. in log10), over the frames of real audio; one
    TF32 pass breaks the limit."""
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    from godot_whisper_tpu.ops import mel_kernel as jax_mel_kernel
    x = _golden_audio() + np.random.default_rng(2).standard_normal(
        5 * 16000).astype(np.float32) * 0.01
    n_real = port_mel.frame_counts(len(x))[1]
    padded = port_mel.pad_audio(x)
    padded = np.pad(padded, (0, -(-len(padded) // 480000) * 480000
                             - len(padded))).astype(np.float16)
    a16 = torch.from_numpy(padded)[None]
    filters_np = port_mel.mel_filterbank(n_mels)
    filters = torch.from_numpy(filters_np)
    basis = torch.from_numpy(mel_kernel.dft_basis())

    def real(d):
        return float(d[..., :n_real].abs().max())
    ref = mel_f64(torch, a16, basis, filters).float()
    lim = mel_limit(real(mel_kernel.log_mel_raw_plain(a16, basis, filters)
                         - ref))
    model = _split_tf32_model(a16, basis, filters)
    tpu = torch.from_numpy(np.array(jax_mel_kernel.log_mel_pallas(
        padded[None], filters_np,
        jax_mel_kernel.pad_filters_256(filters_np))))
    e_ref = real(model - ref)
    e_tpu = 4.0 * real(port_mel.normalize_log_mel(model) - tpu)
    e_tf32 = real(mel_tf32_one_pass(torch, a16, basis, filters) - ref)
    assert e_ref < lim and e_tpu < lim, (e_ref, e_tpu, lim)
    assert e_tf32 > lim, (e_tf32, lim)


@pytest.mark.parametrize("B,F,sm", [(1, 8998, 132), (1, 14998, 132),
                                    (8, 8998, 132), (200, 3000, 132),
                                    (1, 5, 132), (3, 2998, 114)])
def test_mel_ctas_one_wave(B, F, sm):
    """K1's grid: every clip's CTAs fit one wave of ``sm`` CTAs where B
    allows, and no CTA is left without an 8-frame tile."""
    c = mel_kernel.mel_ctas(B, F, sm)
    assert 1 <= c <= -(-F // 8)
    assert c * B <= max(sm, B)
    assert c == -(-F // 8) or c * B > sm - B


def _wide_range_clip(rng, n):
    """n samples over the f16 range and past it: subnormals, halfway
    cases, values that overflow to inf."""
    return (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 5, n)
            ).astype(np.float32)


def _jax_padded_stack(clips):
    """The JAX package's host padding of a batch: its ``pad_audio`` per
    clip, numpy's f16 cast, zeros to the longest clip's 30 s bucket."""
    padded = [jax_mel.pad_audio(c) for c in clips]
    bucket = max(-(-len(p) // 480_000) * 480_000 for p in padded)
    stack = np.zeros((len(clips), bucket), dtype=np.float16)
    with np.errstate(over="ignore"):
        for i, p in enumerate(padded):
            stack[i, :len(p)] = p.astype(np.float16)
    return stack


PAD_CASES = [[0], [1], [2], [150], [199], [200], [201], [202], [479_799],
             [480_000], [480_001],
             [32_000, 480_000, 71_111, 128_000, 480_000, 99_999, 57_003]]
PAD_IDS = [str(n[0]) if len(n) == 1 else "mixed" for n in PAD_CASES]


@pytest.mark.parametrize("ns", PAD_CASES, ids=PAD_IDS)
def test_pad_stack_plain_is_host_padding(ns):
    """The plain pad on a flat buffer (clips back to back between other
    samples, at offsets no multiple of 8) gives the JAX package's
    ``pad_audio(c)`` rounded by numpy's f16 cast and zeros to the bucket,
    bit for bit."""
    rng = np.random.default_rng(len(ns) * 1000 + ns[0] % 997)
    clips = [_wide_range_clip(rng, n) for n in ns]
    parts, offsets = [_wide_range_clip(rng, 13)], []
    for c in clips:
        offsets.append(sum(len(p) for p in parts))
        parts += [c, _wide_range_clip(rng, 5)]
    flat = torch.from_numpy(np.concatenate(parts))
    want = _jax_padded_stack(clips)
    got = mel_kernel.pad_stack(flat, torch.tensor(offsets),
                               torch.tensor(ns), want.shape[1])
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int16),
                                  want.view(np.int16))


@pytest.mark.parametrize("ns", PAD_CASES, ids=PAD_IDS)
def test_card_oracle_is_jax_padding(ns):
    """chip_smoke's ``host_padded_stack``, the oracle of the pad kernel's
    card tests (which run without the JAX package), equals the JAX
    package's host padding bit for bit at the same lengths."""
    rng = np.random.default_rng(len(ns) * 77 + ns[0] % 991)
    clips = [_wide_range_clip(rng, n) for n in ns]
    np.testing.assert_array_equal(host_padded_stack(clips).view(np.int16),
                                  _jax_padded_stack(clips).view(np.int16))


def test_device_batch_equals_host_padded_route():
    """``MelFrontend.device_batch`` on the CPU gives the mel and frame
    counts of the JAX package's host padding through K1's plain version
    bit for bit, batch after batch; ``device`` equals row 0 of
    ``device_batch`` of the clip alone; the span is given 4 bytes a
    sample shipped."""
    rng = np.random.default_rng(11)
    filters = port_mel.mel_filterbank(80)
    front = port_mel.MelFrontend(filters, device="cpu")
    tables = mel_kernel.mel_tables(torch.from_numpy(mel_kernel.dft_basis()),
                                   torch.from_numpy(filters))
    for ns in ([16_000, 0, 3_001], [40_003, 201, 8_000]):
        clips = [(rng.standard_normal(n) * 0.2).astype(np.float32)
                 for n in ns]
        span = CountingSpan()
        mel, n_lens = front.device_batch(clips, span=span)
        want = port_mel.normalize_log_mel(mel_kernel.log_mel_raw(
            torch.from_numpy(_jax_padded_stack(clips)), tables))
        assert torch.equal(mel, want)
        assert n_lens == [min(jax_mel.frame_counts(n)[0], want.shape[2])
                          for n in ns]
        assert span.counts == {"h2d_bytes": 4 * sum(ns)}
    one, n_one = front.device(clips[0])
    alone, n_alone = front.device_batch([clips[0]])
    assert torch.equal(one, alone[0]) and n_one == n_alone[0]
