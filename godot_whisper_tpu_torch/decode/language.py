"""Whisper language registry and auto-detection.

The code→(id, name) table mirrors the reference's ``g_lang``
(whisper.cpp:247-348); auto-detection
mirrors ``whisper_lang_auto_detect_with_state`` (whisper.cpp:3569-3642):
encode the window, run one decode step on ``[sot]`` and softmax over the
language-token logits only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# id -> (code, full name).  Order is the language-token order: the token id of
# language i is token_sot + 1 + i.
LANGUAGES: List[Tuple[str, str]] = [
    ("en", "english"), ("zh", "chinese"), ("de", "german"), ("es", "spanish"),
    ("ru", "russian"), ("ko", "korean"), ("fr", "french"), ("ja", "japanese"),
    ("pt", "portuguese"), ("tr", "turkish"), ("pl", "polish"),
    ("ca", "catalan"), ("nl", "dutch"), ("ar", "arabic"), ("sv", "swedish"),
    ("it", "italian"), ("id", "indonesian"), ("hi", "hindi"),
    ("fi", "finnish"), ("vi", "vietnamese"), ("he", "hebrew"),
    ("uk", "ukrainian"), ("el", "greek"), ("ms", "malay"), ("cs", "czech"),
    ("ro", "romanian"), ("da", "danish"), ("hu", "hungarian"), ("ta", "tamil"),
    ("no", "norwegian"), ("th", "thai"), ("ur", "urdu"), ("hr", "croatian"),
    ("bg", "bulgarian"), ("lt", "lithuanian"), ("la", "latin"),
    ("mi", "maori"), ("ml", "malayalam"), ("cy", "welsh"), ("sk", "slovak"),
    ("te", "telugu"), ("fa", "persian"), ("lv", "latvian"), ("bn", "bengali"),
    ("sr", "serbian"), ("az", "azerbaijani"), ("sl", "slovenian"),
    ("kn", "kannada"), ("et", "estonian"), ("mk", "macedonian"),
    ("br", "breton"), ("eu", "basque"), ("is", "icelandic"),
    ("hy", "armenian"), ("ne", "nepali"), ("mn", "mongolian"),
    ("bs", "bosnian"), ("kk", "kazakh"), ("sq", "albanian"),
    ("sw", "swahili"), ("gl", "galician"), ("mr", "marathi"),
    ("pa", "punjabi"), ("si", "sinhala"), ("km", "khmer"), ("sn", "shona"),
    ("yo", "yoruba"), ("so", "somali"), ("af", "afrikaans"),
    ("oc", "occitan"), ("ka", "georgian"), ("be", "belarusian"),
    ("tg", "tajik"), ("sd", "sindhi"), ("gu", "gujarati"), ("am", "amharic"),
    ("yi", "yiddish"), ("lo", "lao"), ("uz", "uzbek"), ("fo", "faroese"),
    ("ht", "haitian creole"), ("ps", "pashto"), ("tk", "turkmen"),
    ("nn", "nynorsk"), ("mt", "maltese"), ("sa", "sanskrit"),
    ("lb", "luxembourgish"), ("my", "myanmar"), ("bo", "tibetan"),
    ("tl", "tagalog"), ("mg", "malagasy"), ("as", "assamese"),
    ("tt", "tatar"), ("haw", "hawaiian"), ("ln", "lingala"), ("ha", "hausa"),
    ("ba", "bashkir"), ("jw", "javanese"), ("su", "sundanese"),
    ("yue", "cantonese"),
]

_CODE_TO_ID: Dict[str, int] = {code: i for i, (code, _) in enumerate(LANGUAGES)}
_NAME_TO_ID: Dict[str, int] = {name: i for i, (_, name) in enumerate(LANGUAGES)}


def lang_max_id() -> int:
    """Largest valid language id (whisper_lang_max_id, whisper.cpp:3560)."""
    return len(LANGUAGES) - 1


def lang_id(code_or_name: str) -> int:
    """Language id for a code ("en") or full name ("english").

    Mirrors ``whisper_lang_id`` (whisper.cpp:3544-3558).  Returns -1 for
    unknown languages.
    """
    s = code_or_name.lower()
    if s in _CODE_TO_ID:
        return _CODE_TO_ID[s]
    return _NAME_TO_ID.get(s, -1)


def lang_str(lid: int) -> Optional[str]:
    """Short code for a language id (whisper_lang_str)."""
    if 0 <= lid < len(LANGUAGES):
        return LANGUAGES[lid][0]
    return None


def lang_str_full(lid: int) -> Optional[str]:
    """Full language name for an id (whisper_lang_str_full)."""
    if 0 <= lid < len(LANGUAGES):
        return LANGUAGES[lid][1]
    return None


def detect_language_from_logits(logits: np.ndarray, config) -> Tuple[int, np.ndarray]:
    """Given logits of one decode step on [sot], softmax over lang tokens.

    Mirrors whisper_lang_auto_detect_with_state's tail (whisper.cpp:3600-3638).
    Returns (best language id, probability vector over all languages).
    """
    n_lang = min(config.num_languages, len(LANGUAGES))
    lang_token_ids = np.array(
        [config.token_lang(i) for i in range(n_lang)], dtype=np.int64)
    lang_logits = np.asarray(logits, dtype=np.float64)[lang_token_ids]
    lang_logits = lang_logits - lang_logits.max()
    probs = np.exp(lang_logits)
    probs /= probs.sum()
    full = np.zeros(len(LANGUAGES), dtype=np.float64)
    full[:n_lang] = probs
    return int(np.argmax(full)), full
