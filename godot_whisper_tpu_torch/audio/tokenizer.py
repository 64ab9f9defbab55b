"""Whisper tokenizer: vocab container, BPE-style encode, byte decode.

Mirrors the reference's vocab handling and tokenize():
- vocab strings are raw bytes read from the checkpoint
  (whisper.cpp:1205-1292);
- missing special tokens are synthesized with [_..._] names
  (whisper.cpp:1258-1289);
- encoding is regex word-split + greedy longest-match over the vocab
  (whisper.cpp:2893-2947);
- decoding is byte concatenation of id_to_token entries (whisper.cpp:3742).

Matching is done on UTF-8 bytes, exactly like the reference's std::string
substring matching.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from ..models.config import WhisperConfig
from ..decode.language import LANGUAGES, lang_str

# Word-split pattern.  Reference regex (whisper.cpp:2896-2897):
#   's|'t|'re|'ve|'m|'ll|'d| ?[[:alpha:]]+| ?[[:digit:]]+|
#   | ?[^\s[:alpha:][:digit:]]+|\s+(?!\S)|\s+
# Python translation with Unicode letter/digit classes ([^\W\d_] == \p{L}).
_SPLIT_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[^\W\d_]+"
    r"| ?\d+"
    r"| ?(?:[^\s\w]|_)+"
    r"|\s+(?!\S)|\s+"
)

# Tokens suppressed when suppress_non_speech_tokens is set
# (whisper.cpp:4482-4487).
NON_SPEECH_TOKENS = [
    "\"", "#", "(", ")", "*", "+", "/", ":", ";", "<", "=", ">", "@", "[",
    "\\", "]", "^", "_", "`", "{", "|", "}", "~", "「", "」", "『", "』",
    "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"", "((",
    "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪", "♩", "♪", "♫",
    "♬", "♭", "♮", "♯",
]


class Tokenizer:
    """Vocab + encode/decode for one checkpoint."""

    def __init__(self, config: WhisperConfig, tokens: Sequence[bytes]):
        """``tokens`` is the raw vocab from the checkpoint (may be shorter
        than config.n_vocab; the tail is synthesized)."""
        self.config = config
        id_to_token: List[bytes] = list(tokens)

        # Synthesize names for any missing ids (whisper.cpp:1258-1289).
        if len(id_to_token) < config.n_vocab:
            for i in range(len(id_to_token), config.n_vocab):
                if i > config.token_beg:
                    word = f"[_TT_{i - config.token_beg}]"
                elif i == config.token_eot:
                    word = "[_EOT_]"
                elif i == config.token_sot:
                    word = "[_SOT_]"
                elif i == config.token_translate:
                    word = "[_TRANSLATE_]"
                elif i == config.token_transcribe:
                    word = "[_TRANSCRIBE_]"
                elif i == config.token_solm:
                    word = "[_SOLM_]"
                elif i == config.token_prev:
                    word = "[_PREV_]"
                elif i == config.token_nosp:
                    word = "[_NOSP_]"
                elif i == config.token_not:
                    word = "[_NOT_]"
                elif i == config.token_beg:
                    word = "[_BEG_]"
                elif (i > config.token_sot
                      and i <= config.token_sot + config.num_languages):
                    word = f"[_LANG_{lang_str(i - config.token_sot - 1)}]"
                else:
                    word = f"[_extra_token_{i}]"
                id_to_token.append(word.encode("utf-8"))

        self.id_to_token: List[bytes] = id_to_token
        self.token_to_id: Dict[bytes, int] = {}
        for i, t in enumerate(id_to_token):
            # first occurrence wins on duplicates, matching map::operator[]
            # insertion order (later writes overwrite in C++, but duplicates
            # only occur for the empty token in multilingual vocabs)
            self.token_to_id[t] = i

    # ------------------------------------------------------------------ encode
    def encode(self, text: str) -> List[int]:
        """Tokenize text via word split + greedy longest-match
        (whisper.cpp:2899-2947)."""
        tokens: List[int] = []
        for m in _SPLIT_RE.finditer(text):
            word = m.group(0).encode("utf-8")
            if not word:
                continue
            i, n = 0, len(word)
            while i < n:
                found = False
                for j in range(n, i, -1):
                    tid = self.token_to_id.get(word[i:j])
                    if tid is not None:
                        tokens.append(tid)
                        i = j
                        found = True
                        break
                if not found:
                    i += 1  # skip unknown byte, like the reference
        return tokens

    # ------------------------------------------------------------------ decode
    def token_bytes(self, tid: int) -> bytes:
        return self.id_to_token[tid]

    def token_str(self, tid: int) -> str:
        return self.id_to_token[tid].decode("utf-8", errors="replace")

    def decode(self, ids: Sequence[int], *, skip_special: bool = True) -> str:
        """Concatenate token bytes; optionally drop ids >= eot
        (print_special handling at whisper.cpp:5706)."""
        eot = self.config.token_eot
        out = b"".join(
            self.id_to_token[i] for i in ids
            if (not skip_special) or i < eot
        )
        return out.decode("utf-8", errors="replace")

    # -------------------------------------------------------------- utilities
    def non_speech_token_ids(self) -> List[int]:
        """Ids suppressed by suppress_non_speech_tokens, including leading-
        space variants and " -"/" '" (whisper.cpp:4574-4593)."""
        ids = []
        for tok in NON_SPEECH_TOKENS:
            for variant in (tok, " " + tok):
                tid = self.token_to_id.get(variant.encode("utf-8"))
                if tid is not None:
                    ids.append(tid)
        for variant in (" -", " '"):
            tid = self.token_to_id.get(variant.encode("utf-8"))
            if tid is not None:
                ids.append(tid)
        return sorted(set(ids))

    @property
    def space_token_id(self) -> Optional[int]:
        return self.token_to_id.get(b" ")


def synthetic_vocab(config: WhisperConfig) -> List[bytes]:
    """A fully synthetic vocab for tests/benches when no checkpoint is at
    hand: byte tokens + filler words.  Ids >= 256 get unique placeholder
    strings so decode() stays round-trippable for ASCII."""
    toks: List[bytes] = []
    for i in range(256):
        toks.append(bytes([i]))
    for i in range(256, min(config.token_eot, config.n_vocab)):
        toks.append(f"<tok{i}>".encode())
    return toks
