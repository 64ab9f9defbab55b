"""Transcript output writers: txt / vtt / srt / csv / json / lrc / wts.

Mirrors the output family of the reference CLI
(whisper.cpp examples/main/main.cpp:80-169 output flags and the
corresponding output_* functions); the port's copy of the JAX package's
writers over the port's ``Segment``.  Only the JSON ``systeminfo`` string
differs: it names this package's backend.
"""

from __future__ import annotations

import json
from typing import Callable, List

from ..decode.loop import Segment


def _ts(t: int, comma: bool = False) -> str:
    """Centiseconds -> "HH:MM:SS.mmm" (to_timestamp, examples/main)."""
    msec = t * 10
    hr = msec // 3600000
    msec -= hr * 3600000
    mins = msec // 60000
    msec -= mins * 60000
    sec = msec // 1000
    msec -= sec * 1000
    sep = "," if comma else "."
    return f"{hr:02d}:{mins:02d}:{sec:02d}{sep}{msec:03d}"


# Terminal confidence ramp — red (low p) to green (high p), indexed by
# p^3 into 10 buckets (reference examples/main/main.cpp:17-22, :322)
K_COLORS = ["\033[38;5;196m", "\033[38;5;202m", "\033[38;5;208m",
            "\033[38;5;214m", "\033[38;5;220m", "\033[38;5;226m",
            "\033[38;5;190m", "\033[38;5;154m", "\033[38;5;118m",
            "\033[38;5;82m"]


def color_for_p(p: float) -> str:
    i = int((max(0.0, min(1.0, p)) ** 3) * len(K_COLORS))
    return K_COLORS[max(0, min(len(K_COLORS) - 1, i))]


def to_txt(segments: List[Segment]) -> str:
    return "".join(s.text for s in segments).strip() + "\n"


def to_vtt(segments: List[Segment]) -> str:
    out = ["WEBVTT", ""]
    for s in segments:
        speaker = "<v Speaker>" if s.speaker_turn_next else ""
        out.append(f"{_ts(s.t0)} --> {_ts(s.t1)}")
        out.append(f"{speaker}{s.text.strip()}")
        out.append("")
    return "\n".join(out)


def to_srt(segments: List[Segment]) -> str:
    out = []
    for i, s in enumerate(segments, 1):
        out.append(str(i))
        out.append(f"{_ts(s.t0, comma=True)} --> {_ts(s.t1, comma=True)}")
        out.append(s.text.strip())
        out.append("")
    return "\n".join(out)


def to_csv(segments: List[Segment]) -> str:
    lines = ["start,end,text"]
    for s in segments:
        text = s.text.strip().replace('"', '""')
        lines.append(f'{s.t0 * 10},{s.t1 * 10},"{text}"')
    return "\n".join(lines) + "\n"


def to_lrc(segments: List[Segment]) -> str:
    out = ["[by:godot_whisper_tpu]"]
    for s in segments:
        msec = s.t0 * 10
        mins = msec // 60000
        msec -= mins * 60000
        sec = msec // 1000
        msec -= sec * 1000
        out.append(f"[{mins:02d}:{sec:02d}.{msec // 10:02d}]{s.text.strip()}")
    return "\n".join(out) + "\n"


SYSTEM_INFO = "godot_whisper_tpu_torch (PyTorch/CUDA backend)"
DEFAULT_WTS_FONT = "/System/Library/Fonts/Supplemental/Courier New Bold.ttf"


def _wts_escape(s: str) -> str:
    """Quote rules of the reference writer (main.cpp:780-784): apostrophes
    become U+2019 (ffmpeg filter strings are single-quoted), double quotes
    are backslash-escaped."""
    return s.replace("'", "’").replace('"', '\\"')


def _wts_pad(s: str) -> str:
    """Each character of a non-highlighted token renders as an escaped
    space so the karaoke line keeps its monospace alignment."""
    return "\\ " * len(s)


def to_wts(segments: List[Segment], *, input_path: str,
           duration_sec: float, token_to_str: Callable[[int], str],
           eot: int, font_path: str = DEFAULT_WTS_FONT) -> str:
    """Karaoke video script: a bash file running one ffmpeg command that
    draws the segment text in gray with the currently-spoken token
    highlighted (lightgreen + underline) using its token-level timestamps.

    Behavioral mirror of output_wts (examples/main/main.cpp:688-812):
    a black 1200x120 canvas over the audio, one background drawtext per
    segment enabled for [t0, t1], and per non-special token a foreground +
    underline drawtext enabled for that token's [t0, t1] (centiseconds,
    so /100 converts to seconds).  Requires token_timestamps — the CLI
    forces them on when -owts is given, as the reference does
    (main.cpp:936).
    """
    def sec(t_cs) -> str:
        return format(t_cs / 100.0, "g")

    filters: List[str] = []

    def drawtext(color: str, text: str, t0_cs, t1_cs,
                 x: str = "(w-text_w)/2", dy: int = 0) -> str:
        y = "h/2" if dy == 0 else f"h/2+{dy}"
        return (f"drawtext=fontfile='{font_path}':fontsize=24:"
                f"fontcolor={color}:x={x}:y={y}:text='{text}':"
                f"enable='between(t,{sec(t0_cs)},{sec(t1_cs)})'")

    for s in segments:
        toks = [t for t in s.tokens if t.id < eot]
        texts = [token_to_str(t.id) for t in toks]
        # segment separator marker (zero-length enable window, as the
        # reference emits)
        filters.append(drawtext("gray", "", s.t0, s.t0))
        bg = _wts_escape("> " + "".join(texts))
        for j, (tok, txt) in enumerate(zip(toks, texts)):
            if j == 0:
                filters.append(drawtext("gray", bg, s.t0, s.t1))
            fg = "> " + "".join(
                _wts_escape(t2) + "|" if k == j else _wts_pad(t2)
                for k, t2 in enumerate(texts))
            ul = "\\ \\ " + "".join(
                "_" * len(t2) if k == j else _wts_pad(t2)
                for k, t2 in enumerate(texts))
            t0 = max(tok.t0, 0)
            t1 = max(tok.t1, 0)
            filters.append(drawtext("lightgreen", fg, t0, t1,
                                    x="(w-text_w)/2+8"))
            filters.append(drawtext("lightgreen", ul, t0, t1,
                                    x="(w-text_w)/2+8", dy=16))

    vf = ",".join(filters)
    out = input_path + ".mp4"
    return (
        "#!/bin/bash\n"
        "\n"
        f"ffmpeg -i {input_path} -f lavfi -i color=size=1200x120:"
        f"duration={format(duration_sec, 'g')}:rate=25:color=black "
        f"-vf \"{vf}\" -c:v libx264 -pix_fmt yuv420p -y {out}\n"
        "\n\n"
        f"echo \"Your video has been saved to {out}\"\n"
        "\n"
        f"echo \"  ffplay {out}\"\n"
        "\n")


def to_json(segments: List[Segment], *, model_name: str = "",
            language: str = "", full: bool = False) -> str:
    data = {
        "systeminfo": SYSTEM_INFO,
        "model": {"type": model_name},
        "params": {"language": language},
        "transcription": [],
    }
    for s in segments:
        seg = {
            "timestamps": {"from": _ts(s.t0, comma=True),
                           "to": _ts(s.t1, comma=True)},
            "offsets": {"from": s.t0 * 10, "to": s.t1 * 10},
            "text": s.text,
        }
        if full:
            seg["tokens"] = [
                {"text": None, "id": t.id, "p": t.p,
                 "timestamps": {"from": _ts(max(t.t0, 0), comma=True),
                                "to": _ts(max(t.t1, 0), comma=True)}}
                for t in s.tokens
            ]
        if s.speaker_turn_next:
            seg["speaker_turn_next"] = True
        data["transcription"].append(seg)
    return json.dumps(data, indent=2, ensure_ascii=False) + "\n"
