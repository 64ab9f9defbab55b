"""Minimal WAV reader/writer (host-side IO).

The reference reads WAV via dr_wav in examples/common.cpp and via Godot's
AudioStreamWAV (8/16-bit PCM decode at
bin/addons/godot_whisper/audio_stream_to_text.gd:40-46).  This is a
dependency-free RIFF parser covering PCM 8/16/24/32-bit and IEEE float32,
with stereo->mono mixdown matching the glue's 0.5*(l+r)
(src/speech_to_text.cpp:45-51).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str, *, mixdown: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1], sample_rate).

    Multi-channel audio is averaged to mono when ``mixdown`` (the glue's
    stereo handling, src/speech_to_text.cpp:45-51 uses (l+r)/2).
    """
    with open(path, "rb") as f:
        riff, _size, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")

        fmt = None
        data = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", header)
            payload = f.read(chunk_size)
            if chunk_size % 2:
                f.read(1)  # chunks are word-aligned
            if chunk_id == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif chunk_id == b"data":
                data = payload
                if fmt is not None:
                    break

        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

        (audio_format, n_channels, sample_rate, _byte_rate,
         _block_align, bits) = fmt
        if audio_format == 0xFFFE and len(payload) >= 26:
            # WAVE_FORMAT_EXTENSIBLE: sub-format GUID's first 2 bytes
            audio_format = struct.unpack("<H", payload[24:26])[0]

        if audio_format == 3:  # IEEE float
            if bits == 32:
                x = np.frombuffer(data, dtype="<f4").astype(np.float32)
            elif bits == 64:
                x = np.frombuffer(data, dtype="<f8").astype(np.float32)
            else:
                raise ValueError(f"unsupported float bit depth {bits}")
        elif audio_format == 1:  # PCM
            if bits == 8:
                x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32)
                     - 128.0) / 128.0
            elif bits == 16:
                x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
            elif bits == 24:
                raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
                vals = (raw[:, 0].astype(np.int32)
                        | (raw[:, 1].astype(np.int32) << 8)
                        | (raw[:, 2].astype(np.int32) << 16))
                vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
                x = vals.astype(np.float32) / float(1 << 23)
            elif bits == 32:
                x = np.frombuffer(data, dtype="<i4").astype(np.float32) / float(1 << 31)
            else:
                raise ValueError(f"unsupported PCM bit depth {bits}")
        else:
            raise ValueError(f"unsupported WAV format tag {audio_format}")

        if n_channels > 1:
            n = (len(x) // n_channels) * n_channels
            x = x[:n].reshape(-1, n_channels)
            x = x.mean(axis=1) if mixdown else x
        return np.ascontiguousarray(x, dtype=np.float32), sample_rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono float32 samples as 16-bit PCM."""
    x = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(pcm), b"WAVE"))
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(struct.pack("<4sI", b"data", len(pcm)))
        f.write(pcm)
