"""The yardstick's arithmetic: the H100's peaks, the roofline bound, and
the operations and bytes that the traffic's work needs, counted from the
configuration's shapes.

Counts are of the work the traffic needs, not of what a kernel happens to
do: each input byte read once, each output byte written once, operations
from the shapes at their real sizes (1500 audio positions, not a padded
1536; a decode step's live cache slots, not the capacity).  So a count
stays the same whatever kernel does the work later.  A multiply-add is
two operations.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit): 989e12
bf16 / fp16 operations a second on the tensor cores, 495e12 TF32, 67e12
f32 outside them, 3.35e12 bytes a second of HBM3.
"""

from __future__ import annotations

from typing import Dict

PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
            "float32": 67e12}
PEAK_BYTES = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(ops: float, n_bytes: float, dtype: str) -> float:
    """The least time the chip takes: the larger of the operations over
    the dtype's peak and the bytes over HBM's rate."""
    return max(ops / PEAK_OPS[dtype], n_bytes / PEAK_BYTES)


def mfu_pct(ops: float, seconds: float, dtype: str) -> float:
    """Operations done over what the dtype's peak does in ``seconds``, in
    percent."""
    return 100.0 * ops / (seconds * PEAK_OPS[dtype])


def _dims(cfg: dict):
    return (int(cfg["d_model"]), int(cfg["num_mel_bins"]),
            int(cfg["vocab_size"]), int(cfg["max_source_positions"]))


# ------------------------------------------------------------------ layers
def encoder_attention(cfg: dict, n_windows: int) -> Dict[str, float]:
    """Self-attention of the encoder over ``n_windows`` 30 s windows: per
    layer and window, Q.K^T and P.V over A = 1500 positions (4 A^2 S
    operations); Q, K, V read and the output written once (4 A S values
    of the compute dtype)."""
    S, _, _, A = _dims(cfg)
    L = int(cfg["encoder_layers"])
    b = BYTES[cfg["compute_dtype"]]
    return {"ops": 4.0 * A * A * S * L * n_windows,
            "bytes": 4.0 * A * S * b * L * n_windows}


def decode_attention(cfg: dict, n_rows: int, prompt: int, steps: int
                     ) -> Dict[str, float]:
    """The decode steps' attention of ``n_rows`` rows that each run
    ``steps`` steps after a prompt of ``prompt`` tokens, self- and
    cross-attention together (one kernel computes both): at step i a row
    reads the K and V of its prompt + i + 1 live cache slots and of the
    1500 audio positions once a layer, reads its query and writes its f32
    output; 4 x slots x S operations."""
    S, _, _, A = _dims(cfg)
    L = int(cfg["decoder_layers"])
    b = BYTES[cfg["compute_dtype"]]
    self_slots = sum(prompt + i + 1 for i in range(steps))
    slots = self_slots + A * steps
    per_query = S * b + S * 4                      # q read, f32 out written
    return {"ops": 4.0 * slots * S * L * n_rows,
            "bytes": (2.0 * slots * S * b + 2 * steps * per_query)
            * L * n_rows}


# ------------------------------------------------------------- model FLOPs
def encoder_ops(cfg: dict) -> float:
    """One 30 s window through the conv stem and the encoder."""
    S, M, _, A = _dims(cfg)
    L = int(cfg["encoder_layers"])
    ffn = int(cfg["encoder_ffn_dim"])
    stem = 2.0 * (2 * A) * (3 * M) * S + 2.0 * A * (3 * S) * S
    layer = 2.0 * A * 4 * S * S + 2.0 * A * 2 * S * ffn + 4.0 * A * A * S
    return stem + L * layer


def cross_kv_ops(cfg: dict) -> float:
    """One window's K and V for every decoder layer."""
    S, _, _, A = _dims(cfg)
    return 2.0 * A * 2 * S * S * int(cfg["decoder_layers"])


def decoder_token_ops(cfg: dict, context: int) -> float:
    """One token through the decoder layers (self-attention over
    ``context`` slots, cross-attention over the audio), without logits."""
    S, _, _, A = _dims(cfg)
    ffn = int(cfg["decoder_ffn_dim"])
    layer = (2.0 * 6 * S * S + 2.0 * 2 * S * ffn
             + 4.0 * context * S + 4.0 * A * S)
    return int(cfg["decoder_layers"]) * layer


def logits_ops(cfg: dict) -> float:
    S, _, V, _ = _dims(cfg)
    return 2.0 * S * V


def serve_window_ops(cfg: dict, prompt: int, tokens: int) -> float:
    """A served window: encoder, cross-K/V, the prompt pass (logits of its
    last position), and a decode step for each served token after the
    first (its logits included)."""
    ops = encoder_ops(cfg) + cross_kv_ops(cfg)
    ops += sum(decoder_token_ops(cfg, t + 1) for t in range(prompt))
    ops += logits_ops(cfg)
    for i in range(tokens - 1):
        ops += decoder_token_ops(cfg, prompt + i + 1) + logits_ops(cfg)
    return ops


def train_row_forward_ops(cfg: dict, T: int) -> float:
    """One row's forward pass in training: the window through the encoder
    and cross-K/V, T teacher-forced tokens with causal self-attention, and
    T positions of logits."""
    ops = encoder_ops(cfg) + cross_kv_ops(cfg)
    ops += sum(decoder_token_ops(cfg, t + 1) for t in range(T))
    return ops + T * logits_ops(cfg)
