"""GBNF grammar-constrained decoding, a copy of the JAX package's
``decode/grammar.py`` (pure Python; the port keeps its own copy so that it
never imports the JAX package).

Python re-implementation of the llama.cpp-style grammar engine vendored in
the reference (whisper.cpp:3875-4301) plus the GBNF text parser
(examples/grammar-parser.cpp):

- incremental UTF-8 decode tolerant of split sequences (whisper.cpp:3881);
- pushdown stacks advanced over char ranges / rule refs (:4024-4107);
- candidate rejection over the vocabulary (:4109-4179);
- soft penalty: rejected tokens get ``grammar_penalty`` SUBTRACTED from
  their logits — not -inf (:4252-4256);
- tokens starting with "[_" (specials) bypass acceptance (:4274-4277).

Grammar decoding is host-stepped (the grammar state is an unbounded
pushdown automaton, advanced on the host after every token); the pipeline
switches to the host-stepped loop in decode/host_loop.py when
``grammar_rules`` is set, exactly as slow-per-token as the reference's own
decode loop — everything else stays on the batched window and clip paths.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple


class GreType(enum.Enum):
    END = 0
    ALT = 1
    RULE_REF = 2
    CHAR = 3
    CHAR_NOT = 4
    CHAR_RNG_UPPER = 5
    CHAR_ALT = 6


@dataclasses.dataclass(frozen=True)
class Element:
    type: GreType
    value: int = 0


Rule = List[Element]
# A stack entry is (rule_id, position) — the Python analogue of the C++
# element pointer; hashable so stacks can be deduplicated.
StackEntry = Tuple[int, int]
Stack = Tuple[StackEntry, ...]


@dataclasses.dataclass
class PartialUtf8:
    value: int = 0
    n_remain: int = 0


def decode_utf8(data: bytes, partial: PartialUtf8
                ) -> Tuple[List[int], PartialUtf8]:
    """Incremental UTF-8 decode (whisper.cpp:3881-3935).  Returns the
    code points (with terminating 0) and the trailing partial state."""
    lookup = [1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 2, 2, 3, 4]
    pos = 0
    code_points: List[int] = []
    value = partial.value
    n_remain = partial.n_remain

    while pos < len(data) and n_remain > 0:
        nxt = data[pos]
        if (nxt >> 6) != 2:
            return [0], PartialUtf8(0, -1)
        value = (value << 6) + (nxt & 0x3F)
        pos += 1
        n_remain -= 1

    if partial.n_remain > 0 and n_remain == 0:
        code_points.append(value)

    while pos < len(data):
        first = data[pos]
        highbits = first >> 4
        n_remain = lookup[highbits] - 1
        if n_remain < 0:
            return [0], PartialUtf8(0, n_remain)
        mask = (1 << (7 - n_remain)) - 1
        value = first & mask
        pos += 1
        while pos < len(data) and n_remain > 0:
            value = (value << 6) + (data[pos] & 0x3F)
            pos += 1
            n_remain -= 1
        if n_remain == 0:
            code_points.append(value)

    code_points.append(0)
    return code_points, PartialUtf8(value, n_remain)


class Grammar:
    """Grammar state: rules + live pushdown stacks + partial UTF-8."""

    def __init__(self, rules: List[Rule], start_rule: int = 0):
        self.rules = rules
        self.partial_utf8 = PartialUtf8()
        self.stacks: List[Stack] = []
        # init stacks from the alternates of the start rule
        # (whisper_grammar_init, whisper.cpp:4196-4216)
        pos = 0
        rule = rules[start_rule]
        while True:
            stack: List[StackEntry] = []
            if not self._is_eos(start_rule, pos):
                stack.append((start_rule, pos))
            self._advance_stack(tuple(stack), self.stacks)
            while not self._is_eos(start_rule, pos):
                pos += 1
            if rule[pos].type == GreType.ALT:
                pos += 1
            else:
                break
        self._dedupe()

    # ------------------------------------------------------------- internals
    def _is_eos(self, rule_id: int, pos: int) -> bool:
        t = self.rules[rule_id][pos].type
        return t in (GreType.END, GreType.ALT)

    def _match_char(self, entry: StackEntry, chr_: int
                    ) -> Tuple[bool, StackEntry]:
        """(matched, position after the char class)
        (whisper_grammar_match_char, whisper.cpp:3948-3970)."""
        rule_id, pos = entry
        rule = self.rules[rule_id]
        el = rule[pos]
        is_positive = el.type == GreType.CHAR
        found = False
        while True:
            if (pos + 1 < len(rule)
                    and rule[pos + 1].type == GreType.CHAR_RNG_UPPER):
                found = found or (rule[pos].value <= chr_
                                  <= rule[pos + 1].value)
                pos += 2
            else:
                found = found or rule[pos].value == chr_
                pos += 1
            if pos >= len(rule) or rule[pos].type != GreType.CHAR_ALT:
                break
        return found == is_positive, (rule_id, pos)

    def _match_partial(self, entry: StackEntry,
                       partial: PartialUtf8) -> bool:
        """(whisper_grammar_match_partial_char, whisper.cpp:3975-4019)."""
        rule_id, pos = entry
        rule = self.rules[rule_id]
        is_positive = rule[pos].type == GreType.CHAR
        value, n_remain = partial.value, partial.n_remain
        if n_remain < 0 or (n_remain == 1 and value < 2):
            return False
        low = value << (n_remain * 6)
        high = low | ((1 << (n_remain * 6)) - 1)
        if low == 0:
            if n_remain == 2:
                low = 1 << 11
            elif n_remain == 3:
                low = 1 << 16
        while True:
            if (pos + 1 < len(rule)
                    and rule[pos + 1].type == GreType.CHAR_RNG_UPPER):
                if rule[pos].value <= high and low <= rule[pos + 1].value:
                    return is_positive
                pos += 2
            else:
                if low <= rule[pos].value <= high:
                    return is_positive
                pos += 1
            if pos >= len(rule) or rule[pos].type != GreType.CHAR_ALT:
                break
        return not is_positive

    def _advance_stack(self, stack: Stack, out: List[Stack]) -> None:
        """(whisper_grammar_advance_stack, whisper.cpp:4024-4075)."""
        if not stack:
            if stack not in out:
                out.append(stack)
            return
        rule_id, pos = stack[-1]
        el = self.rules[rule_id][pos]
        if el.type == GreType.RULE_REF:
            sub_id = el.value
            sub_pos = 0
            while True:
                new_stack = list(stack[:-1])
                if not self._is_eos(rule_id, pos + 1):
                    new_stack.append((rule_id, pos + 1))
                if not self._is_eos(sub_id, sub_pos):
                    new_stack.append((sub_id, sub_pos))
                self._advance_stack(tuple(new_stack), out)
                while not self._is_eos(sub_id, sub_pos):
                    sub_pos += 1
                if self.rules[sub_id][sub_pos].type == GreType.ALT:
                    sub_pos += 1
                else:
                    break
        elif el.type in (GreType.CHAR, GreType.CHAR_NOT):
            if stack not in out:
                out.append(stack)
        else:
            raise AssertionError("malformed grammar stack")

    def _dedupe(self) -> None:
        seen = set()
        unique = []
        for s in self.stacks:
            if s not in seen:
                seen.add(s)
                unique.append(s)
        self.stacks = unique

    def _accept_char(self, chr_: int) -> None:
        """(whisper_grammar_accept, whisper.cpp:4081-4107)."""
        new_stacks: List[Stack] = []
        for stack in self.stacks:
            if not stack:
                continue
            matched, after = self._match_char(stack[-1], chr_)
            if matched:
                new_stack = list(stack[:-1])
                if not self._is_eos(*after):
                    new_stack.append(after)
                self._advance_stack(tuple(new_stack), new_stacks)
        self.stacks = new_stacks
        self._dedupe()

    # ----------------------------------------------------------------- public
    def accept_token(self, token_bytes: bytes) -> None:
        """(whisper_grammar_accept_token, whisper.cpp:4265-4287)."""
        if not self.rules or not self.stacks:
            return
        if token_bytes.startswith(b"[_"):
            return
        code_points, self.partial_utf8 = decode_utf8(token_bytes,
                                                     self.partial_utf8)
        for cp in code_points[:-1]:
            self._accept_char(cp)

    def reject_tokens(self, vocab: Sequence[bytes], eot: int) -> List[int]:
        """Token ids < eot rejected by every live stack
        (whisper_grammar_reject_candidates + suppress loop,
        whisper.cpp:4109-4179, 4241-4252)."""
        if not self.rules or not self.stacks:
            return []
        candidates = []
        for tid in range(min(eot, len(vocab))):
            text = vocab[tid]
            if not text:
                continue
            cps, partial = decode_utf8(text, self.partial_utf8)
            candidates.append((tid, tuple(cps), partial))

        rejects = self._reject_for_stack(self.stacks[0], candidates)
        for stack in self.stacks[1:]:
            rejects = self._reject_for_stack(stack, rejects)
        return [tid for tid, _, _ in rejects]

    def _reject_for_stack(self, stack: Stack, candidates):
        """(whisper_grammar_reject_candidates_for_stack,
        whisper.cpp:4114-4163)."""
        rejects = []
        if not stack:
            for tok in candidates:
                tid, cps, partial = tok
                if cps[0] != 0 or partial.n_remain != 0:
                    rejects.append(tok)
            return rejects

        top = stack[-1]
        next_candidates = []
        for tok in candidates:
            tid, cps, partial = tok
            if cps[0] == 0:
                if (partial.n_remain != 0
                        and not self._match_partial(top, partial)):
                    rejects.append(tok)
            elif self._match_char(top, cps[0])[0]:
                next_candidates.append((tid, cps[1:], partial))
            else:
                rejects.append(tok)

        _, after = self._match_char(top, 0)
        stack_after = list(stack[:-1])
        if not self._is_eos(*after):
            stack_after.append(after)
        next_stacks: List[Stack] = []
        self._advance_stack(tuple(stack_after), next_stacks)

        # recurse over the advanced stacks; empty stacks or candidates mean
        # no further rejects (whisper_grammar_reject_candidates,
        # whisper.cpp:4165-4171)
        if next_candidates and next_stacks:
            sub_rejects = self._reject_for_stack(next_stacks[0],
                                                 next_candidates)
            for st in next_stacks[1:]:
                sub_rejects = self._reject_for_stack(st, sub_rejects)
            by_id = {tok[0]: tok for tok in candidates}
            for tid, _, _ in sub_rejects:
                rejects.append(by_id[tid])  # pointer rewound one code point
        return rejects


# ------------------------------------------------------------------ parser --
class GBNFParseError(ValueError):
    pass


def parse_gbnf(text: str) -> Tuple[List[Rule], Dict[str, int]]:
    """Parse GBNF grammar text into rule arrays
    (examples/grammar-parser.cpp semantics: rule ::= alternates separated by
    '|', terminals as "lit" / [ranges], (...) groups, */+/? repetition)."""
    symbol_ids: Dict[str, int] = {}
    rules: Dict[int, Rule] = {}

    def get_symbol_id(name: str) -> int:
        if name not in symbol_ids:
            symbol_ids[name] = len(symbol_ids)
        return symbol_ids[name]

    def generate_symbol_id(base: str) -> int:
        next_id = len(symbol_ids)
        symbol_ids[f"{base}_{next_id}"] = next_id
        return next_id

    i = 0
    n = len(text)

    def skip_ws(newlines: bool = True):
        nonlocal i
        while i < n:
            if text[i] == "#":
                while i < n and text[i] != "\n":
                    i += 1
            elif text[i] in " \t" or (newlines and text[i] in "\r\n"):
                i += 1
            else:
                break

    def parse_name() -> str:
        nonlocal i
        start = i
        while i < n and (text[i].isalnum() or text[i] in "-_"):
            i += 1
        if i == start:
            raise GBNFParseError(f"expected name at {start}")
        return text[start:i]

    def parse_char() -> int:
        nonlocal i
        c = text[i]
        if c == "\\":
            i += 1
            esc = text[i]
            i += 1
            mapping = {"n": 10, "t": 9, "r": 13, '"': 34, "[": 91,
                       "]": 93, "\\": 92}
            if esc in mapping:
                return mapping[esc]
            if esc in ("x",):
                v = int(text[i:i + 2], 16)
                i += 2
                return v
            if esc == "u":
                v = int(text[i:i + 4], 16)
                i += 4
                return v
            if esc == "U":
                v = int(text[i:i + 8], 16)
                i += 8
                return v
            raise GBNFParseError(f"bad escape \\{esc}")
        i += 1
        return ord(c)

    def parse_sequence(rule_name: str, out: Rule):
        nonlocal i
        last_start = None
        while i < n:
            skip_ws(newlines=False)
            if i >= n:
                break
            c = text[i]
            if c == '"':
                i += 1
                last_start = len(out)
                while text[i] != '"':
                    out.append(Element(GreType.CHAR, parse_char()))
                i += 1
            elif c == "[":
                i += 1
                last_start = len(out)
                neg = text[i] == "^"
                if neg:
                    i += 1
                first = True
                while text[i] != "]":
                    t = (GreType.CHAR_NOT if neg and first
                         else (GreType.CHAR if first else GreType.CHAR_ALT))
                    v = parse_char()
                    out.append(Element(t, v))
                    first = False
                    if text[i] == "-" and text[i + 1] != "]":
                        i += 1
                        out.append(Element(GreType.CHAR_RNG_UPPER,
                                           parse_char()))
                i += 1
            elif c == "(":
                i += 1
                sub_id = generate_symbol_id(rule_name)
                parse_alternates(rule_name, sub_id)
                if text[i] != ")":
                    raise GBNFParseError("expected )")
                i += 1
                last_start = len(out)
                out.append(Element(GreType.RULE_REF, sub_id))
            elif c in "*+?":
                i += 1
                if last_start is None:
                    raise GBNFParseError("repetition without target")
                sub = out[last_start:]
                sub_id = generate_symbol_id(rule_name)
                if c in "*+":
                    rules[sub_id] = (sub + [Element(GreType.RULE_REF, sub_id),
                                            Element(GreType.ALT)]
                                     + ([] if c == "*" else [])
                                     + [Element(GreType.END)])
                    if c == "+":
                        # S ::= sub S | sub
                        rules[sub_id] = (sub
                                         + [Element(GreType.RULE_REF, sub_id),
                                            Element(GreType.ALT)]
                                         + sub + [Element(GreType.END)])
                else:  # ?
                    rules[sub_id] = sub + [Element(GreType.ALT),
                                           Element(GreType.END)]
                del out[last_start:]
                out.append(Element(GreType.RULE_REF, sub_id))
                last_start = len(out) - 1
            elif c.isalnum() or c in "-_":
                name = parse_name()
                last_start = len(out)
                out.append(Element(GreType.RULE_REF, get_symbol_id(name)))
            else:
                break

    def parse_alternates(rule_name: str, rule_id: int):
        nonlocal i
        out: Rule = []
        parse_sequence(rule_name, out)
        skip_ws(newlines=False)
        while i < n and text[i] == "|":
            i += 1
            out.append(Element(GreType.ALT))
            skip_ws()
            parse_sequence(rule_name, out)
            skip_ws(newlines=False)
        out.append(Element(GreType.END))
        rules[rule_id] = out

    skip_ws()
    while i < n:
        name = parse_name()
        skip_ws(newlines=False)
        if text[i:i + 3] != "::=":
            raise GBNFParseError(f"expected ::= after {name}")
        i += 3
        skip_ws(newlines=False)
        rule_id = get_symbol_id(name)
        parse_alternates(name, rule_id)
        skip_ws()

    rule_list = [rules.get(rid, [Element(GreType.END)])
                 for rid in range(len(symbol_ids))]
    return rule_list, symbol_ids


def grammar_from_gbnf(text: str, start: str = "root") -> Grammar:
    rules, symbols = parse_gbnf(text)
    if start not in symbols:
        raise GBNFParseError(f"no start rule {start!r}")
    return Grammar(rules, symbols[start])
