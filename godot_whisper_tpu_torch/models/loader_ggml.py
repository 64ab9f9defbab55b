"""ggml ``.bin`` checkpoint reader/writer.

File layout (mirrors ``whisper_model_load``,
whisper.cpp:1102-1640):

    uint32  magic = 0x67676d6c ("ggml")
    int32 x 11 hparams: n_vocab, n_audio_ctx, n_audio_state, n_audio_head,
                        n_audio_layer, n_text_ctx, n_text_state, n_text_head,
                        n_text_layer, n_mels, ftype
    int32 n_mel, int32 n_fft_bins, f32[n_mel*n_fft_bins] mel filterbank
    int32 n_vocab_file, then per token: uint32 len + raw bytes
    tensor records until EOF:
        int32 n_dims, int32 name_len, int32 ggml_type
        int32 ne[n_dims]          (ne[0] = fastest-varying dim)
        name bytes
        raw tensor data (row-major with ne[0] fastest)

A file with zero tensor records is a valid *stub* checkpoint ("assuming empty
model for testing", whisper.cpp:1627-1628) — the reference ships these as
``models/for-tests-ggml-*.bin`` and we generate our own via
``write_stub_checkpoint`` for CI.

This module is pure NumPy (host-side IO); conversion into device arrays with
the target dtype/sharding happens in ``params.py``.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np

from .config import WhisperConfig, config_from_hparams

GGML_MAGIC = 0x67676D6C
QNT_VERSION_FACTOR = 1000

# ggml_type enum values (ggml.h:325-341)
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q4_1 = 3
GGML_TYPE_Q5_0 = 6
GGML_TYPE_Q5_1 = 7
GGML_TYPE_Q8_0 = 8
GGML_TYPE_Q2_K = 10
GGML_TYPE_Q3_K = 11
GGML_TYPE_Q4_K = 12
GGML_TYPE_Q5_K = 13
GGML_TYPE_Q6_K = 14

# ggml_ftype file-level hints (ggml.h:362-377): 0=f32, 1=f16, 2=q4_0,
# 3=q4_1, 8=q5_0, 9=q5_1, 7=q8_0, 10..14 = q2_K..q6_K.
FTYPE_TO_TYPE = {0: GGML_TYPE_F32, 1: GGML_TYPE_F16, 2: GGML_TYPE_Q4_0,
                 3: GGML_TYPE_Q4_1, 7: GGML_TYPE_Q8_0, 8: GGML_TYPE_Q5_0,
                 9: GGML_TYPE_Q5_1, 10: GGML_TYPE_Q2_K, 11: GGML_TYPE_Q3_K,
                 12: GGML_TYPE_Q4_K, 13: GGML_TYPE_Q5_K, 14: GGML_TYPE_Q6_K}

_QBLOCK = 32   # elements per block, simple Q formats
_QK_K = 256    # elements per super-block, K-quant formats (ggml-quants.h:66)

# bytes per super-block, matching the block_q*_K static_asserts
# (ggml-quants.h:81-158)
_K_BLOCK_BYTES = {GGML_TYPE_Q2_K: 84, GGML_TYPE_Q3_K: 110,
                  GGML_TYPE_Q4_K: 144, GGML_TYPE_Q5_K: 176,
                  GGML_TYPE_Q6_K: 210}


@dataclasses.dataclass
class RawCheckpoint:
    """Host-side checkpoint contents before pytree conversion."""

    config: WhisperConfig
    ftype: int
    qnt_version: int
    mel_filters: np.ndarray          # (n_mel, n_fft_bins) float32
    vocab_tokens: List[bytes]
    tensors: Dict[str, np.ndarray]   # name -> float32 ndarray, numpy shape
                                     #   = reversed(ne)  (row-major)

    @property
    def n_loaded(self) -> int:
        return len(self.tensors)


def _read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", f.read(4))[0]


def _read_u32(f: BinaryIO) -> int:
    return struct.unpack("<I", f.read(4))[0]


# --------------------------------------------------------------------- dequant
def _dequant(ttype: int, raw: bytes, n_elements: int) -> np.ndarray:
    """Dequantize a ggml-quants tensor payload to float32.

    Block layouts per ggml-quants.h:10-47 (Q4_0/Q4_1/Q5_0/Q5_1/Q8_0, 32
    elements per block).
    """
    n_blocks = n_elements // _QBLOCK
    buf = np.frombuffer(raw, dtype=np.uint8)
    if ttype == GGML_TYPE_Q4_0:
        rec = buf.reshape(n_blocks, 18)
        d = rec[:, :2].copy().view(np.float16).astype(np.float32)  # (nb,1)
        qs = rec[:, 2:]
        lo = (qs & 0x0F).astype(np.int8)
        hi = (qs >> 4).astype(np.int8)
        q = np.concatenate([lo, hi], axis=1).astype(np.float32) - 8.0
        return (q * d).reshape(-1)
    if ttype == GGML_TYPE_Q4_1:
        rec = buf.reshape(n_blocks, 20)
        d = rec[:, :2].copy().view(np.float16).astype(np.float32)
        m = rec[:, 2:4].copy().view(np.float16).astype(np.float32)
        qs = rec[:, 4:]
        lo = (qs & 0x0F)
        hi = (qs >> 4)
        q = np.concatenate([lo, hi], axis=1).astype(np.float32)
        return (q * d + m).reshape(-1)
    if ttype == GGML_TYPE_Q5_0:
        rec = buf.reshape(n_blocks, 22)
        d = rec[:, :2].copy().view(np.float16).astype(np.float32)
        qh = rec[:, 2:6].copy().view(np.uint32).reshape(n_blocks, 1)
        qs = rec[:, 6:]
        shifts = np.arange(32, dtype=np.uint32)
        hbits = ((qh >> shifts) & 1).astype(np.uint8)  # (nb, 32)
        lo = (qs & 0x0F)
        hi = (qs >> 4)
        q = np.concatenate([lo, hi], axis=1)
        q = (q | (hbits << 4)).astype(np.float32) - 16.0
        return (q * d).reshape(-1)
    if ttype == GGML_TYPE_Q5_1:
        rec = buf.reshape(n_blocks, 24)
        d = rec[:, :2].copy().view(np.float16).astype(np.float32)
        m = rec[:, 2:4].copy().view(np.float16).astype(np.float32)
        qh = rec[:, 4:8].copy().view(np.uint32).reshape(n_blocks, 1)
        qs = rec[:, 8:]
        shifts = np.arange(32, dtype=np.uint32)
        hbits = ((qh >> shifts) & 1).astype(np.uint8)
        lo = (qs & 0x0F)
        hi = (qs >> 4)
        q = np.concatenate([lo, hi], axis=1)
        q = (q | (hbits << 4)).astype(np.float32)
        return (q * d + m).reshape(-1)
    if ttype == GGML_TYPE_Q8_0:
        rec = buf.reshape(n_blocks, 34)
        d = rec[:, :2].copy().view(np.float16).astype(np.float32)
        q = rec[:, 2:].copy().view(np.int8).astype(np.float32)
        return (q * d).reshape(-1)
    if ttype in _K_BLOCK_BYTES:
        return _dequant_k(ttype, buf, n_elements)
    raise ValueError(f"unsupported ggml tensor type {ttype}")


# ----------------------------------------------------------- K-quant formats
# Super-block codecs (QK_K = 256).  Bit layouts and element ordering follow
# the reference dequantize_row_q*_K loops (ggml-quants.c:1551-1580 q2_K,
# :1677-1722 q3_K, :1853-1881 q4_K, :1976-2005 q5_K, :2116-2147 q6_K);
# vectorized over all super-blocks at once.

def _f16(col: np.ndarray) -> np.ndarray:
    """(nb, 2) uint8 -> (nb, 1) float32 via little-endian fp16."""
    return col.copy().view(np.float16).astype(np.float32)


def _unpack_scale_min_k4(scales: np.ndarray):
    """Inverse-of-storage for the 12-byte q4_K/q5_K scale block: 8 6-bit
    (scale, min) pairs (get_scale_min_k4, ggml-quants.c:1827-1835)."""
    b = scales.astype(np.uint8)                    # (nb, 12)
    j = np.arange(4)
    sc_lo = b[:, j] & 63                           # groups 0..3
    mn_lo = b[:, j + 4] & 63
    sc_hi = (b[:, j + 8] & 0xF) | ((b[:, j] >> 6) << 4)        # groups 4..7
    mn_hi = (b[:, j + 8] >> 4) | ((b[:, j + 4] >> 6) << 4)
    sc = np.concatenate([sc_lo, sc_hi], axis=1).astype(np.float32)
    mn = np.concatenate([mn_lo, mn_hi], axis=1).astype(np.float32)
    return sc, mn                                  # (nb, 8) each


def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Encode 8 6-bit (scale, min) codes into the 12-byte layout."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    nb = sc.shape[0]
    out = np.empty((nb, 12), dtype=np.uint8)
    j = np.arange(4)
    out[:, j] = (sc[:, j] & 63) | ((sc[:, j + 4] >> 4) << 6)
    out[:, j + 4] = (mn[:, j] & 63) | ((mn[:, j + 4] >> 4) << 6)
    out[:, j + 8] = (sc[:, j + 4] & 0xF) | ((mn[:, j + 4] & 0xF) << 4)
    return out


def _unpack_scales_q3k(scales12: np.ndarray) -> np.ndarray:
    """12-byte q3_K scale block -> (nb, 16) int 6-bit codes (the kmask
    shuffle at ggml-quants.c:1687-1692), NOT yet offset by -32."""
    b = scales12.astype(np.uint8)                  # (nb, 12)
    p = np.arange(4)
    lo0 = b[:, p] & 0xF            # word0 low nibbles  -> codes 0..3 low
    lo1 = b[:, p + 4] & 0xF        # word1 low nibbles  -> codes 4..7 low
    hi0 = b[:, p] >> 4             # word0 high nibbles -> codes 8..11 low
    hi1 = b[:, p + 4] >> 4         # word1 high nibbles -> codes 12..15 low
    top = b[:, p + 8]              # word2: 2 top bits per code group
    c0 = lo0 | (((top >> 0) & 3) << 4)
    c1 = lo1 | (((top >> 2) & 3) << 4)
    c2 = hi0 | (((top >> 4) & 3) << 4)
    c3 = hi1 | (((top >> 6) & 3) << 4)
    return np.concatenate([c0, c1, c2, c3], axis=1).astype(np.int32)


def _pack_scales_q3k(codes: np.ndarray) -> np.ndarray:
    """Encode (nb, 16) 6-bit codes into the 12-byte q3_K layout."""
    c = codes.astype(np.uint8)
    nb = c.shape[0]
    out = np.empty((nb, 12), dtype=np.uint8)
    p = np.arange(4)
    out[:, p] = (c[:, p] & 0xF) | ((c[:, p + 8] & 0xF) << 4)
    out[:, p + 4] = (c[:, p + 4] & 0xF) | ((c[:, p + 12] & 0xF) << 4)
    out[:, p + 8] = ((c[:, p] >> 4) | ((c[:, p + 4] >> 4) << 2)
                     | ((c[:, p + 8] >> 4) << 4) | ((c[:, p + 12] >> 4) << 6))
    return out


def _dequant_k(ttype: int, buf: np.ndarray, n_elements: int) -> np.ndarray:
    nb = n_elements // _QK_K
    rec = buf.reshape(nb, _K_BLOCK_BYTES[ttype])
    shifts = np.arange(4, dtype=np.uint8) * 2      # 2-bit lanes

    if ttype == GGML_TYPE_Q2_K:
        scales, qs = rec[:, :16], rec[:, 16:80]
        d, dmin = _f16(rec[:, 80:82]), _f16(rec[:, 82:84])
        # elements ordered (half, shift, lane): half-blocks of 128, four
        # 2-bit planes per byte, 32 lanes
        q = ((qs.reshape(nb, 2, 1, 32) >> shifts[None, None, :, None]) & 3)
        q = q.reshape(nb, 256).astype(np.float32)
        sc = np.repeat((scales & 0xF).astype(np.float32), 16, axis=1)
        mn = np.repeat((scales >> 4).astype(np.float32), 16, axis=1)
        return (d * sc * q - dmin * mn).reshape(-1)

    if ttype == GGML_TYPE_Q3_K:
        hmask, qs, s12 = rec[:, :32], rec[:, 32:96], rec[:, 96:108]
        d = _f16(rec[:, 108:110])
        q = ((qs.reshape(nb, 2, 1, 32) >> shifts[None, None, :, None]) & 3)
        # high bit: hmask bit (half*4 + plane) per lane; NOT set -> -4
        bits = (np.arange(2)[:, None] * 4 + np.arange(4)[None, :])  # (2,4)
        hb = ((hmask.reshape(nb, 1, 1, 32)
               >> bits[None, :, :, None].astype(np.uint8)) & 1)
        qv = q.astype(np.float32) - np.where(hb, 0.0, 4.0)
        qv = qv.reshape(nb, 256)
        sc = np.repeat(
            (_unpack_scales_q3k(s12) - 32).astype(np.float32), 16, axis=1)
        return (d * sc * qv).reshape(-1)

    if ttype == GGML_TYPE_Q4_K:
        d, dmin = _f16(rec[:, 0:2]), _f16(rec[:, 2:4])
        sc, mn = _unpack_scale_min_k4(rec[:, 4:16])
        qs = rec[:, 16:144].reshape(nb, 4, 32)
        lo = (qs & 0xF).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        # element order per 64-chunk: 32 low nibbles then 32 high nibbles
        q = np.stack([lo, hi], axis=2).reshape(nb, 256)
        scr = np.repeat(sc, 32, axis=1)
        mnr = np.repeat(mn, 32, axis=1)
        return (d * scr * q - dmin * mnr).reshape(-1)

    if ttype == GGML_TYPE_Q5_K:
        d, dmin = _f16(rec[:, 0:2]), _f16(rec[:, 2:4])
        sc, mn = _unpack_scale_min_k4(rec[:, 4:16])
        qh = rec[:, 16:48]                          # (nb, 32)
        qs = rec[:, 48:176].reshape(nb, 4, 32)
        lo = (qs & 0xF).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        c = np.arange(4, dtype=np.uint8)
        hb_lo = ((qh[:, None, :] >> (2 * c)[None, :, None]) & 1)
        hb_hi = ((qh[:, None, :] >> (2 * c + 1)[None, :, None]) & 1)
        lo = lo + 16.0 * hb_lo
        hi = hi + 16.0 * hb_hi
        q = np.stack([lo, hi], axis=2).reshape(nb, 256)
        scr = np.repeat(sc, 32, axis=1)
        mnr = np.repeat(mn, 32, axis=1)
        return (d * scr * q - dmin * mnr).reshape(-1)

    if ttype == GGML_TYPE_Q6_K:
        ql = rec[:, 0:128].reshape(nb, 2, 64)
        qh = rec[:, 128:192].reshape(nb, 2, 32)
        sc = rec[:, 192:208].copy().view(np.int8).reshape(nb, 2, 8)
        d = _f16(rec[:, 208:210])
        lo_a, lo_b = ql[:, :, :32], ql[:, :, 32:]   # lanes l, l+32
        # four 32-wide sub-blocks per half: (ql source, nibble, qh plane)
        q1 = (lo_a & 0xF) | (((qh >> 0) & 3) << 4)
        q2 = (lo_b & 0xF) | (((qh >> 2) & 3) << 4)
        q3 = (lo_a >> 4) | (((qh >> 4) & 3) << 4)
        q4 = (lo_b >> 4) | (((qh >> 6) & 3) << 4)
        q = np.stack([q1, q2, q3, q4], axis=2).astype(np.float32) - 32.0
        # scale index within a half: sub*2 + lane//16
        scf = sc.astype(np.float32)                 # (nb, 2, 8)
        idx = (np.arange(4)[:, None] * 2
               + (np.arange(32) // 16)[None, :])    # (4, 32)
        scg = scf[:, :, idx]                        # (nb, 2, 4, 32)
        return (d.reshape(nb, 1, 1, 1) * scg * q.reshape(
            nb, 2, 4, 32)).reshape(-1)

    raise ValueError(f"unsupported K-quant type {ttype}")


def quantize_blocks(ttype: int, arr: np.ndarray) -> bytes:
    """Quantize a float32 array to ggml block format (encode side of
    _dequant; reference kernels in ggml-quants.c)."""
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    n = flat.size
    assert n % _QBLOCK == 0, "tensor size must be a multiple of 32"
    blocks = flat.reshape(-1, _QBLOCK)
    nb = blocks.shape[0]
    if ttype == GGML_TYPE_Q8_0:
        d = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
        d_safe = np.where(d == 0, 1.0, d)
        q = np.clip(np.round(blocks / d_safe), -127, 127).astype(np.int8)
        out = np.empty((nb, 34), dtype=np.uint8)
        out[:, :2] = d.astype("<f2").view(np.uint8)
        out[:, 2:] = q.view(np.uint8)
        return out.tobytes()
    if ttype == GGML_TYPE_Q4_0:
        amax_idx = np.argmax(np.abs(blocks), axis=1)
        maxv = blocks[np.arange(nb), amax_idx]           # signed max-|x|
        d = maxv / -8.0
        d_safe = np.where(d == 0, 1.0, d)
        q = np.clip(np.round(blocks / d_safe[:, None]) + 8, 0, 15
                    ).astype(np.uint8)
        lo, hi = q[:, :16], q[:, 16:]
        out = np.empty((nb, 18), dtype=np.uint8)
        out[:, :2] = d.astype("<f2")[:, None].view(np.uint8)
        out[:, 2:] = lo | (hi << 4)
        return out.tobytes()
    if ttype == GGML_TYPE_Q4_1:
        mn = blocks.min(axis=1)
        mx = blocks.max(axis=1)
        d = (mx - mn) / 15.0
        d_safe = np.where(d == 0, 1.0, d)
        q = np.clip(np.round((blocks - mn[:, None]) / d_safe[:, None]),
                    0, 15).astype(np.uint8)
        lo, hi = q[:, :16], q[:, 16:]
        out = np.empty((nb, 20), dtype=np.uint8)
        out[:, :2] = d.astype("<f2")[:, None].view(np.uint8)
        out[:, 2:4] = mn.astype("<f2")[:, None].view(np.uint8)
        out[:, 4:] = lo | (hi << 4)
        return out.tobytes()
    if ttype in _K_BLOCK_BYTES:
        assert n % _QK_K == 0, "K-quants need a multiple of 256 elements"
        return _quantize_k(ttype, flat)
    raise ValueError(f"unsupported quantization target {ttype}")


def _asym_group_codes(g: np.ndarray, qmax: int, cmax: int):
    """Asymmetric per-group fit x ~ scale*q - min (min >= 0), then quantize
    the per-group (scale, min) pairs to ``cmax``-code integers against
    super-block f16 deltas.  g: (nb, n_groups, group_len)."""
    gmax = np.maximum(g.max(axis=2), 0.0)
    gmin = np.minimum(g.min(axis=2), 0.0)
    scale = (gmax - gmin) / qmax                   # (nb, G)
    mins = -gmin                                   # >= 0
    d = (scale.max(axis=1, keepdims=True) / cmax).astype(np.float16
                                                         ).astype(np.float32)
    dmin = (mins.max(axis=1, keepdims=True) / cmax).astype(np.float16
                                                           ).astype(np.float32)
    sc = np.clip(np.round(scale / np.where(d > 0, d, 1.0)), 0, cmax)
    mn = np.clip(np.round(mins / np.where(dmin > 0, dmin, 1.0)), 0, cmax)
    # quantize elements against the DECODED scale/min (what dequant sees)
    eff_s = d * sc                                 # (nb, G)
    eff_m = dmin * mn
    q = np.clip(np.round((g + eff_m[..., None])
                         / np.where(eff_s > 0, eff_s, 1.0)[..., None]),
                0, qmax).astype(np.uint8)
    return q, sc.astype(np.uint8), mn.astype(np.uint8), d, dmin


def _sym_group_codes(g: np.ndarray, qlim: int, cmax: int):
    """Symmetric per-group fit x ~ scale*q with signed ``q`` in
    [-qlim, qlim-1] and signed scale codes in [-cmax, cmax-1]."""
    absmax = np.abs(g).max(axis=2)
    scale = absmax / qlim                          # (nb, G)
    d = (scale.max(axis=1, keepdims=True) / (cmax - 1)).astype(
        np.float16).astype(np.float32)
    sc = np.clip(np.round(scale / np.where(d > 0, d, 1.0)),
                 -cmax, cmax - 1)
    eff = d * sc
    q = np.clip(np.round(g / np.where(eff > 0, eff, 1.0)[..., None]),
                -qlim, qlim - 1).astype(np.int32)
    return q, sc.astype(np.int32), d


def _quantize_k(ttype: int, flat: np.ndarray) -> bytes:
    """Encode float32 data into a K-quant super-block stream.  Simple
    absmax/minmax group fits (the reference searches scales iteratively,
    quantize_row_q*_K_reference — same formats, better RMSE; decoders are
    interchangeable)."""
    blocks = flat.reshape(-1, _QK_K)
    nb = blocks.shape[0]

    if ttype == GGML_TYPE_Q2_K:
        g = blocks.reshape(nb, 16, 16)
        q, sc, mn, d, dmin = _asym_group_codes(g, qmax=3, cmax=15)
        out = np.empty((nb, 84), dtype=np.uint8)
        out[:, :16] = sc | (mn << 4)
        # pack 2-bit q in (half, shift, lane) order
        qq = q.reshape(nb, 2, 4, 32)
        packed = (qq[:, :, 0] | (qq[:, :, 1] << 2) | (qq[:, :, 2] << 4)
                  | (qq[:, :, 3] << 6))
        out[:, 16:80] = packed.reshape(nb, 64)
        out[:, 80:82] = d.astype("<f2").view(np.uint8)
        out[:, 82:84] = dmin.astype("<f2").view(np.uint8)
        return out.tobytes()

    if ttype == GGML_TYPE_Q3_K:
        g = blocks.reshape(nb, 16, 16)
        q, sc, d = _sym_group_codes(g, qlim=4, cmax=32)
        qb = (q + 4).astype(np.uint8)              # 0..7: hbit + 2 bits
        hbit = qb >> 2                             # set bit = "no -4 offset"
        lo = qb & 3                                # (ggml-quants.c:1705-1712)
        lo4 = lo.reshape(nb, 2, 4, 32)
        packed = (lo4[:, :, 0] | (lo4[:, :, 1] << 2) | (lo4[:, :, 2] << 4)
                  | (lo4[:, :, 3] << 6))
        hb = hbit.reshape(nb, 2, 4, 32)
        bits = (np.arange(2)[:, None] * 4 + np.arange(4)[None, :])
        hm = (hb.astype(np.uint32)
              << bits[None, :, :, None].astype(np.uint32)).sum(
                  axis=(1, 2)).astype(np.uint8)    # (nb, 32)
        out = np.empty((nb, 110), dtype=np.uint8)
        out[:, :32] = hm
        out[:, 32:96] = packed.reshape(nb, 64)
        out[:, 96:108] = _pack_scales_q3k((sc + 32).reshape(nb, 16))
        out[:, 108:110] = d.astype("<f2").view(np.uint8)
        return out.tobytes()

    if ttype in (GGML_TYPE_Q4_K, GGML_TYPE_Q5_K):
        g = blocks.reshape(nb, 8, 32)
        qmax = 15 if ttype == GGML_TYPE_Q4_K else 31
        q, sc, mn, d, dmin = _asym_group_codes(g, qmax=qmax, cmax=63)
        qq = q.reshape(nb, 4, 2, 32)               # (chunk, lo/hi, lane)
        lo, hi = qq[:, :, 0], qq[:, :, 1]
        if ttype == GGML_TYPE_Q4_K:
            out = np.empty((nb, 144), dtype=np.uint8)
            out[:, 0:2] = d.astype("<f2").view(np.uint8)
            out[:, 2:4] = dmin.astype("<f2").view(np.uint8)
            out[:, 4:16] = _pack_scale_min_k4(sc, mn)
            out[:, 16:] = ((lo & 0xF) | ((hi & 0xF) << 4)).reshape(nb, 128)
            return out.tobytes()
        out = np.empty((nb, 176), dtype=np.uint8)
        out[:, 0:2] = d.astype("<f2").view(np.uint8)
        out[:, 2:4] = dmin.astype("<f2").view(np.uint8)
        out[:, 4:16] = _pack_scale_min_k4(sc, mn)
        c = np.arange(4, dtype=np.uint32)
        qh = (((lo >> 4).astype(np.uint32) << (2 * c)[None, :, None])
              | ((hi >> 4).astype(np.uint32)
                 << (2 * c + 1)[None, :, None])).sum(axis=1).astype(np.uint8)
        out[:, 16:48] = qh
        out[:, 48:] = ((lo & 0xF) | ((hi & 0xF) << 4)).reshape(nb, 128)
        return out.tobytes()

    if ttype == GGML_TYPE_Q6_K:
        g = blocks.reshape(nb, 16, 16)
        q, sc, d = _sym_group_codes(g, qlim=32, cmax=128)
        qb = (q + 32).astype(np.uint8)             # 0..63
        qs = qb.reshape(nb, 2, 4, 32)              # (half, sub, lane)
        q1, q2, q3, q4 = (qs[:, :, i] for i in range(4))
        ql = np.concatenate(
            [(q1 & 0xF) | ((q3 & 0xF) << 4),
             (q2 & 0xF) | ((q4 & 0xF) << 4)], axis=2)  # (nb, 2, 64)
        qh = ((q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4)
              | ((q4 >> 4) << 6))                  # (nb, 2, 32)
        out = np.empty((nb, 210), dtype=np.uint8)
        out[:, 0:128] = ql.reshape(nb, 128)
        out[:, 128:192] = qh.reshape(nb, 64)
        out[:, 192:208] = sc.reshape(nb, 16).astype(np.int8).view(np.uint8)
        out[:, 208:210] = d.astype("<f2").view(np.uint8)
        return out.tobytes()

    raise ValueError(f"unsupported K-quant target {ttype}")


def _type_nbytes(ttype: int, n_elements: int) -> int:
    if ttype == GGML_TYPE_F32:
        return 4 * n_elements
    if ttype == GGML_TYPE_F16:
        return 2 * n_elements
    if ttype in _K_BLOCK_BYTES:
        assert n_elements % _QK_K == 0
        return _K_BLOCK_BYTES[ttype] * (n_elements // _QK_K)
    per_block = {GGML_TYPE_Q4_0: 18, GGML_TYPE_Q4_1: 20, GGML_TYPE_Q5_0: 22,
                 GGML_TYPE_Q5_1: 24, GGML_TYPE_Q8_0: 34}[ttype]
    assert n_elements % _QBLOCK == 0
    return per_block * (n_elements // _QBLOCK)


# ------------------------------------------------------------------------ read
def read_checkpoint(path_or_file: Union[str, BinaryIO, bytes]) -> RawCheckpoint:
    """Read a ggml .bin checkpoint into host memory."""
    if isinstance(path_or_file, (bytes, bytearray)):
        f: BinaryIO = io.BytesIO(path_or_file)
        close = False
    elif isinstance(path_or_file, str):
        f = open(path_or_file, "rb")
        close = True
    else:
        f = path_or_file
        close = False

    try:
        magic = _read_u32(f)
        if magic != GGML_MAGIC:
            raise ValueError(f"bad magic 0x{magic:08x} (expected ggml)")

        hp = [_read_i32(f) for _ in range(11)]
        ftype = hp[10]
        qnt_version = ftype // QNT_VERSION_FACTOR
        ftype %= QNT_VERSION_FACTOR
        config = config_from_hparams(*hp[:10])

        n_mel = _read_i32(f)
        n_fft_bins = _read_i32(f)
        filt = np.frombuffer(
            f.read(4 * n_mel * n_fft_bins), dtype="<f4"
        ).reshape(n_mel, n_fft_bins).copy()

        n_vocab_file = _read_i32(f)
        vocab: List[bytes] = []
        for _ in range(n_vocab_file):
            ln = _read_u32(f)
            vocab.append(f.read(ln) if ln else b"")

        tensors: Dict[str, np.ndarray] = {}
        while True:
            header = f.read(12)
            if len(header) < 12:
                break
            n_dims, name_len, ttype = struct.unpack("<iii", header)
            ne = [1, 1, 1, 1]
            n_elements = 1
            for i in range(n_dims):
                ne[i] = _read_i32(f)
                n_elements *= ne[i]
            name = f.read(name_len).decode("utf-8")
            nbytes = _type_nbytes(ttype, n_elements)
            raw = f.read(nbytes)
            if len(raw) < nbytes:
                raise ValueError(f"truncated tensor {name!r}")
            if ttype == GGML_TYPE_F32:
                flat = np.frombuffer(raw, dtype="<f4").astype(np.float32)
            elif ttype == GGML_TYPE_F16:
                flat = np.frombuffer(raw, dtype="<f2").astype(np.float32)
            else:
                flat = _dequant(ttype, raw, n_elements)
            # numpy shape = reversed(ne): ne[0] is the fastest dim.
            shape = tuple(reversed(ne[:max(1, n_dims)]))
            tensors[name] = flat.reshape(shape)

        return RawCheckpoint(
            config=config, ftype=ftype, qnt_version=qnt_version,
            mel_filters=filt, vocab_tokens=vocab, tensors=tensors)
    finally:
        if close:
            f.close()


# ----------------------------------------------------------------------- write
def write_checkpoint(
    path: str,
    config: WhisperConfig,
    mel_filters: np.ndarray,
    vocab_tokens: List[bytes],
    tensors: Optional[Dict[str, Tuple[np.ndarray, int]]] = None,
    *,
    ftype: int = 1,
    qnt_version: int = 2,
) -> None:
    """Write a ggml .bin checkpoint.

    ``tensors`` maps name -> (float32 ndarray with numpy shape = reversed(ne),
    ggml type id).  With ``tensors=None`` a weightless stub checkpoint is
    produced (the CI test-model trick, whisper.cpp:1627-1628).
    """
    with open(path, "wb") as f:
        f.write(struct.pack("<I", GGML_MAGIC))
        c = config
        for v in (c.n_vocab, c.n_audio_ctx, c.n_audio_state, c.n_audio_head,
                  c.n_audio_layer, c.n_text_ctx, c.n_text_state,
                  c.n_text_head, c.n_text_layer, c.n_mels,
                  qnt_version * QNT_VERSION_FACTOR + ftype):
            f.write(struct.pack("<i", v))

        n_mel, n_fft_bins = mel_filters.shape
        f.write(struct.pack("<ii", n_mel, n_fft_bins))
        f.write(np.ascontiguousarray(mel_filters, dtype="<f4").tobytes())

        f.write(struct.pack("<i", len(vocab_tokens)))
        for tok in vocab_tokens:
            f.write(struct.pack("<I", len(tok)))
            f.write(tok)

        if tensors:
            for name, (arr, ttype) in tensors.items():
                ne = list(reversed(arr.shape))
                name_b = name.encode("utf-8")
                f.write(struct.pack("<iii", len(ne), len(name_b), ttype))
                for d in ne:
                    f.write(struct.pack("<i", d))
                f.write(name_b)
                if ttype == GGML_TYPE_F32:
                    f.write(np.ascontiguousarray(arr, dtype="<f4").tobytes())
                elif ttype == GGML_TYPE_F16:
                    f.write(np.ascontiguousarray(arr, dtype="<f2").tobytes())
                else:
                    f.write(quantize_blocks(ttype, arr))


def write_stub_checkpoint(path: str, config: WhisperConfig,
                          mel_filters: np.ndarray,
                          vocab_tokens: List[bytes]) -> None:
    """Weightless stub checkpoint for tests (mirrors for-tests-ggml-*.bin)."""
    write_checkpoint(path, config, mel_filters, vocab_tokens, tensors=None,
                     ftype=1)
