"""K1: raw log-mel spectrogram (csrc/mel.cu) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/mel_kernel.py`` (TPU kernel
``_mel_kernel``): frames of 400 samples at hop 160 from f16 audio, the
periodic-Hann windowed DFT, power over 201 bins, the mel filterbank,
``log10(max(x, 1e-10))``.  The clip-global max-8 clamp and ``(x + 4) / 4``
stay outside the kernel (audio/mel.py), as in the JAX package.  The kernel
runs the DFT on the tensor cores in split TF32 against a basis stored in
its fragment order and sums each mel's run of nonzero bins (``MelTables``,
built once per filterbank).  ``pad_stack`` builds K1's input on the card
(csrc/mel.cu's ``gwt_mel_pad``) from a batch's real samples.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.config import HOP_LENGTH, N_FFT
from . import kernels as K

N_FFT_BINS = N_FFT // 2 + 1  # 201
PAD = N_FFT // 2             # samples reflected at a clip's head
K_STEPS = N_FFT // 8        # the kernel's mma k-steps
BIN_TILES = 26               # the kernel's 8-bin tiles: 208 >= 201 bins


@functools.lru_cache(maxsize=1)
def dft_basis() -> np.ndarray:
    """(400, 2 * 201) f32: hann * cos | -hann * sin, built in f64 from the
    f32 periodic Hann window, exactly as the JAX package's
    ``_windowed_dft_basis``."""
    n = np.arange(N_FFT, dtype=np.float64)[:, None]
    k = np.arange(N_FFT_BINS, dtype=np.float64)[None, :]
    theta = 2.0 * np.pi * n * k / N_FFT
    win = (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
           ).astype(np.float32).astype(np.float64)[:, None]
    return np.concatenate([np.cos(theta) * win, -np.sin(theta) * win],
                          axis=1).astype(np.float32)


def log_mel_raw_plain(audio: torch.Tensor, basis: torch.Tensor,
                      filters: torch.Tensor) -> torch.Tensor:
    """(B, L) f16 audio -> (B, n_mels, F) f32 raw log10 mel,
    F = (L - 400) // 160 + 1."""
    frames = audio.float().unfold(-1, N_FFT, HOP_LENGTH)   # (B, F, 400)
    spec = frames @ basis                                  # (B, F, 402)
    re, im = spec[..., :N_FFT_BINS], spec[..., N_FFT_BINS:]
    power = re * re + im * im
    mel = power @ filters.T                                # (B, F, n_mels)
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


def frag_basis(basis: np.ndarray) -> np.ndarray:
    """(50, 26, 32, 4) f32: ``basis`` (400, 402) in the order in which the
    kernel reads its A fragments (mma.sync m16n8k8 TF32).  Entry [ks, bt,
    lane, j] is the value of 8-bin tile ``bt`` at k-step ``ks`` that lane
    ``lane`` holds in fragment register ``j``: bin 8 bt + lane // 4 (bins
    past 200 are 0), sample 8 ks + lane % 4 + 4 (j // 2), hann.cos for even
    ``j`` and -hann.sin for odd ``j``."""
    cos = np.zeros((N_FFT, 8 * BIN_TILES), np.float32)
    msin = np.zeros_like(cos)
    cos[:, :N_FFT_BINS] = basis[:, :N_FFT_BINS]
    msin[:, :N_FFT_BINS] = basis[:, N_FFT_BINS:]
    ks = np.arange(K_STEPS)[:, None, None, None]
    bt = np.arange(BIN_TILES)[None, :, None, None]
    lane = np.arange(32)[None, None, :, None]
    j = np.arange(4)[None, None, None, :]
    n = 8 * ks + lane % 4 + 4 * (j // 2)
    k = 8 * bt + lane // 4
    return np.where(j % 2 == 0, cos[n, k], msin[n, k]).astype(np.float32)


def mel_runs(filters: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each mel's run of bins from its first to its last nonzero, packed:
    ``runs`` (n_mels, 3) int32 (first bin, last bin, offset of the run's
    first weight; first > last for a row with none) and ``weights`` (the
    runs' filterbank values back to back, f32, at least one entry).  A sum
    over the run in bin order equals the dense sum in bin order: the zeros
    outside it add nothing."""
    filters = np.asarray(filters, dtype=np.float32)
    runs = np.zeros((filters.shape[0], 3), np.int32)
    parts = []
    off = 0
    for m, row in enumerate(filters):
        nz = np.flatnonzero(row)
        k0, k1 = (nz[0], nz[-1]) if nz.size else (0, -1)
        runs[m] = k0, k1, off
        parts.append(row[k0:k1 + 1])
        off += k1 - k0 + 1
    weights = np.concatenate(parts + [np.zeros(1, np.float32)])[:max(off, 1)]
    return runs, weights


class MelTables(NamedTuple):
    """What K1 reads besides the audio, built once per filterbank on one
    device (``MelFrontend`` owns it): the plain version's ``basis`` (400,
    402) and ``filters`` (n_mels, 201); on a CUDA device also the kernel's
    ``frag_basis``, ``runs`` and ``weights`` (``mel_runs``), None on the
    CPU, whose route never reads them."""
    basis: torch.Tensor
    filters: torch.Tensor
    frag_basis: Optional[torch.Tensor] = None
    runs: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None


def mel_tables(basis: torch.Tensor, filters: torch.Tensor) -> MelTables:
    """K1's tables on ``filters``' device from the (400, 402) basis and the
    (n_mels, 201) filterbank."""
    dev = filters.device
    basis = basis.to(dev)
    if dev.type != "cuda":
        return MelTables(basis, filters)
    runs, weights = mel_runs(filters.detach().cpu().numpy())
    return MelTables(basis, filters,
                     torch.from_numpy(frag_basis(
                         basis.detach().cpu().numpy())).to(dev),
                     torch.from_numpy(runs).to(dev),
                     torch.from_numpy(weights).to(dev))


def mel_ctas(B: int, n_frames: int, sm_count: int) -> int:
    """CTAs a clip: all clips' CTAs in one wave, each CTA at least one
    8-frame tile (a CTA streams the whole basis once per chunk of at most
    9 tiles, so fewer, longer ranges reuse it more)."""
    return max(1, min(-(-n_frames // 8), sm_count // B))


def log_mel_raw(audio: torch.Tensor, tables: MelTables) -> torch.Tensor:
    """Kernel wrapper: CUDA tensors launch csrc/mel.cu, CPU tensors take
    the plain version.  audio (B, L) f16; ``tables`` from ``mel_tables``
    on the audio's device."""
    if audio.device.type == "cpu":
        return log_mel_raw_plain(audio, tables.basis, tables.filters)
    if tables.frag_basis is None:
        raise ValueError("log_mel_raw: CUDA audio needs the tables of "
                         "mel_tables on a CUDA device")
    K.require_cuda("log_mel_raw", audio, tables.frag_basis, tables.runs,
                   tables.weights)
    B, L = audio.shape
    n_mels = tables.runs.shape[0]
    if (audio.dtype != torch.float16 or tables.frag_basis.dtype
            != torch.float32 or tables.weights.dtype != torch.float32
            or tables.runs.dtype != torch.int32
            or tuple(tables.frag_basis.shape) != (K_STEPS, BIN_TILES, 32, 4)
            or tables.runs.shape[1] != 3 or L < N_FFT):
        raise ValueError("log_mel_raw: audio (B, L>=400) f16 and the "
                         "tables of mel_tables")
    n_frames = (L - N_FFT) // HOP_LENGTH + 1
    out = torch.empty((B, n_mels, n_frames), dtype=torch.float32,
                      device=audio.device)
    ctas = mel_ctas(B, n_frames, K.sm_count(audio.device.index or 0))
    fn = K.entry("mel", "gwt_mel", (K.P, K.P, K.P, K.P, K.P, K.I, K.I, K.I,
                                    K.I, K.I, K.I, K.P))
    K.launch(fn, "gwt_mel", audio.device,
             audio.data_ptr(), tables.frag_basis.data_ptr(),
             tables.runs.data_ptr(), tables.weights.data_ptr(),
             out.data_ptr(), B, L, n_frames, n_mels,
             tables.weights.numel(), ctas)
    log_mel_raw.launches += 1
    return out


log_mel_raw.launches = 0


def pad_stack_plain(flat: torch.Tensor, offsets: torch.Tensor,
                    lengths: torch.Tensor, bucket: int) -> torch.Tensor:
    """(B, bucket) f16: row b is clip b, ``flat[offsets[b]:][:lengths[b]]``,
    as audio/mel.py's ``pad_audio`` pads it (its samples 1..200 reversed at
    the head, for a clip of n <= 200 its n - 1 reversed samples and then
    zeros), rounded to f16 and followed by zeros; positions past
    ``bucket`` are dropped."""
    B = offsets.numel()
    out = torch.zeros((B, bucket), dtype=torch.float16, device=flat.device)
    for b, (o, n) in enumerate(zip(offsets.tolist(), lengths.tolist())):
        x = flat[o:o + n]
        m = min(n - 1, PAD)
        if m > 0:
            out[b, :m] = x[1:m + 1].flip(0)
        k = max(0, min(n, bucket - PAD))
        out[b, PAD:PAD + k] = x[:k]
    return out


def pad_stack(flat: torch.Tensor, offsets: torch.Tensor,
              lengths: torch.Tensor, bucket: int) -> torch.Tensor:
    """Kernel wrapper: CUDA tensors launch csrc/mel.cu's ``gwt_mel_pad``,
    CPU tensors take ``pad_stack_plain``.  ``flat`` (N,) f32, the clips'
    samples back to back; ``offsets`` and ``lengths`` (B,) int64 on its
    device; ``bucket`` a multiple of 8 of at least 400."""
    if flat.device.type == "cpu":
        return pad_stack_plain(flat, offsets, lengths, bucket)
    K.require_cuda("pad_stack", flat, offsets, lengths)
    B = offsets.numel()
    if (flat.dtype != torch.float32 or flat.dim() != 1
            or offsets.dtype != torch.int64 or lengths.dtype != torch.int64
            or lengths.numel() != B or not 0 < B <= 65535
            or bucket % 8 or not N_FFT <= bucket < 2 ** 31):
        raise ValueError("pad_stack: flat (N,) f32, offsets and lengths "
                         "(B,) int64 with 0 < B <= 65535, bucket a "
                         "multiple of 8 in [400, 2^31)")
    out = torch.empty((B, bucket), dtype=torch.float16, device=flat.device)
    fn = K.entry("mel", "gwt_mel_pad", (K.P, K.P, K.P, K.P, K.I, K.I, K.P))
    K.launch(fn, "gwt_mel_pad", flat.device, flat.data_ptr(),
             offsets.data_ptr(), lengths.data_ptr(), out.data_ptr(), B,
             bucket)
    pad_stack.launches += 1
    return out


pad_stack.launches = 0
