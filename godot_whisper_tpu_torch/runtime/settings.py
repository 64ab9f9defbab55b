"""Runtime settings registry, copied from the JAX package's
``runtime/settings.py``.

The framework equivalent of the three-tier config of the reference
(SURVEY.md §5): compile-time defines become module constants, the params
struct is decode/params.py, and the Godot ProjectSettings tier
(``audio/input/transcribe/*`` registered at
godot-whisper src/register_types.cpp:64-69) becomes this process-wide
settings dict with the same keys and defaults, overridable from the
environment (``GWT_<KEY>`` with dots replaced by underscores).
"""

from __future__ import annotations

import os
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    # mirror register_types.cpp:64-69
    "audio.input.transcribe.entropy_threshold": 2.8,
    "audio.input.transcribe.freq_threshold": 200.0,
    "audio.input.transcribe.max_tokens": 16,
    "audio.input.transcribe.vad_threshold": 2.0,
    "audio.input.transcribe.use_gpu": True,       # accepted, the card is implied
    "audio.input.transcribe.speed_up_2x": False,  # reserved, like upstream
}

_settings: Dict[str, Any] = dict(_DEFAULTS)


def get_setting(key: str, default: Any = None) -> Any:
    env_key = "GWT_" + key.replace(".", "_").replace("/", "_").upper()
    if env_key in os.environ:
        raw = os.environ[env_key]
        cur = _settings.get(key, default)
        if isinstance(cur, bool):
            return raw.lower() in ("1", "true", "yes")
        if isinstance(cur, int):
            return int(raw)
        if isinstance(cur, float):
            return float(raw)
        return raw
    return _settings.get(key, default)


def set_setting(key: str, value: Any) -> None:
    _settings[key] = value


def all_settings() -> Dict[str, Any]:
    return dict(_settings)


def reset_settings() -> None:
    _settings.clear()
    _settings.update(_DEFAULTS)
