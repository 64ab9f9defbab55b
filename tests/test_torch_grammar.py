"""The port's copy of the GBNF grammar engine (``decode/grammar.py``) against
the JAX package's: every case of tests/test_grammar.py run on both modules,
and the same parses, acceptances and ``reject_tokens`` lists on shared
grammars and vocabularies (exact: the engine is pure Python)."""

import pytest

from godot_whisper_tpu.decode import grammar as jax_grammar
from godot_whisper_tpu_torch.decode import grammar as port_grammar

PKGS = pytest.mark.parametrize("G", [jax_grammar, port_grammar],
                               ids=["jax", "port"])

GRAMMARS = [
    'root ::= "yes" | "no"\n',
    "root ::= [0-9]+\n",
    "root ::= [a-z ]+\n",
    'root ::= " turn on the light" | " turn off the light" | " stop"\n',
    'root ::= greeting " " name\ngreeting ::= "hi" | "hello"\n'
    'name ::= [A-Z] [a-z]*\n',
    'root ::= ("ab" | [^x-z])* "!"?\n',
    'root ::= [\\u00e9a-c]+ "\\n"\n',
]

VOCAB = [b"yes", b"no", b"maybe", b"y", b"n", b"q", b"", b" ", b"1", b"42",
         b"a", b"ab", b"hi", b"hello", b" Bob", b"B", b"ob", b"!", b"x",
         b"\xc3", b"\xa9", "é".encode(), b"\n", b"[_BEG_]", b" turn",
         b" on", b" the", b" light", b" stop", b"off", b"Z", b"hello "]


@PKGS
def test_decode_utf8_ascii(G):
    cps, partial = G.decode_utf8(b"abc", G.PartialUtf8())
    assert cps == [97, 98, 99, 0]
    assert partial.n_remain == 0


@PKGS
def test_decode_utf8_multibyte(G):
    cps, _ = G.decode_utf8("é♪".encode(), G.PartialUtf8())
    assert cps == [0xE9, 0x266A, 0]


@PKGS
def test_decode_utf8_partial(G):
    raw = "é".encode()
    cps, partial = G.decode_utf8(raw[:1], G.PartialUtf8())
    assert cps == [0] and partial.n_remain == 1
    cps2, partial2 = G.decode_utf8(raw[1:], partial)
    assert cps2 == [0xE9, 0] and partial2.n_remain == 0


@PKGS
def test_parse_simple_grammar(G):
    rules, symbols = G.parse_gbnf('root ::= "yes" | "no"\n')
    assert "root" in symbols
    assert len(rules[symbols["root"]]) > 0


@PKGS
def test_grammar_accepts_valid_string(G):
    g = G.grammar_from_gbnf('root ::= "yes" | "no"\n')
    for ch in b"yes":
        g._accept_char(ch)
    assert any(len(s) == 0 for s in g.stacks)


@PKGS
def test_grammar_rejects_invalid_prefix(G):
    g = G.grammar_from_gbnf('root ::= "yes" | "no"\n')
    g._accept_char(ord("x"))
    assert g.stacks == []


@PKGS
def test_reject_tokens_vocabulary(G):
    g = G.grammar_from_gbnf('root ::= "yes" | "no"\n')
    vocab = [b"yes", b"no", b"maybe", b"y", b"n", b"q", b""]
    rejected = set(g.reject_tokens(vocab, len(vocab)))
    assert 2 in rejected and 5 in rejected
    assert not rejected & {0, 1, 3, 4}


@PKGS
def test_reject_after_acceptance(G):
    g = G.grammar_from_gbnf('root ::= "yes" | "no"\n')
    g.accept_token(b"y")
    vocab = [b"es", b"o", b"x", b"e"]
    rejected = set(g.reject_tokens(vocab, len(vocab)))
    assert 1 in rejected and 2 in rejected
    assert 0 not in rejected and 3 not in rejected


@PKGS
def test_char_ranges(G):
    g = G.grammar_from_gbnf("root ::= [0-9]+\n")
    vocab = [b"1", b"42", b"a", b" ", b"9"]
    assert set(g.reject_tokens(vocab, len(vocab))) == {2, 3}


@PKGS
def test_specials_skip_acceptance(G):
    g = G.grammar_from_gbnf('root ::= "ok"\n')
    stacks_before = list(g.stacks)
    g.accept_token(b"[_BEG_]")
    assert g.stacks == stacks_before


def _trace(G, text, steps):
    """Parse, then after each accepted token the rejected ids over VOCAB
    (the end-of-text id included) and the stacks."""
    rules, symbols = G.parse_gbnf(text)
    g = G.grammar_from_gbnf(text)
    out = [repr(rules), sorted(symbols.items())]
    for tok in steps:
        out.append(g.reject_tokens(VOCAB, len(VOCAB)))
        g.accept_token(tok)
        out.append([list(map(repr, s)) for s in g.stacks])
    out.append(g.reject_tokens(VOCAB, len(VOCAB)))
    return out


@pytest.mark.parametrize("text", GRAMMARS, ids=range(len(GRAMMARS)))
def test_same_parse_accept_and_reject_as_jax(text):
    steps = [b"h", b"el", b"lo", b" ", b"B", b"ob", b"\xc3", b"\xa9", b"!",
             b"[_BEG_]", b"1", b"yes"]
    assert _trace(port_grammar, text, steps) == _trace(jax_grammar, text,
                                                       steps)
