"""Entry kinds: how a cell drives the program.  A workload file names its
kind (``"entry": "batch"``); the module of that name here runs it.

Each module defines ``Entry(cfg, spec, seed, device)`` with:

- ``E2E``: the end-to-end metrics it reports, with their units;
- ``setup()``: weights, program, traffic, warm-up of every shape;
- ``window(seconds) -> (e2e values, facts)``: the measured window; facts
  are the counts the per-layer readers need;
- ``release()``: drop the program's state before the check;
- ``check() -> [(name, value, limit), ...]``: the numbers that decide
  ``correct``, each correct when value <= limit;
- ``attempted`` / ``failed``: counts of the window's requests or steps.
"""

from __future__ import annotations

import importlib


def load(kind: str):
    return importlib.import_module(f"{__name__}.{kind}").Entry


def port_config(cfg: dict):
    """The program's ``WhisperConfig`` for a configuration file."""
    from godot_whisper_tpu_torch.models.config import WhisperConfig

    return WhisperConfig(
        name=cfg["port_name"], n_vocab=int(cfg["vocab_size"]),
        n_audio_ctx=int(cfg["max_source_positions"]),
        n_audio_state=int(cfg["d_model"]),
        n_audio_head=int(cfg["encoder_attention_heads"]),
        n_audio_layer=int(cfg["encoder_layers"]),
        n_text_ctx=int(cfg["max_target_positions"]),
        n_text_state=int(cfg["d_model"]),
        n_text_head=int(cfg["decoder_attention_heads"]),
        n_text_layer=int(cfg["decoder_layers"]),
        n_mels=int(cfg["num_mel_bins"]))
