"""SQL tokenizer (counterpart of daft_tpu/sql/tokenizer.py): a
self-contained lexer producing a flat token stream for the Pratt parser
(sql/parser.py). Comments (``--`` and ``/* */``), string literals with
``''`` escapes, quoted identifiers, numbers, identifiers and keywords,
operators and punctuation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Token:
    kind: str   # 'ident', 'number', 'string', 'op', 'punct', 'eof'
    value: str
    pos: int

    def upper(self) -> str:
        return self.value.upper()


_MULTI_OPS = ("<=", ">=", "<>", "!=", "||", "::")
_SINGLE_OPS = "+-*/%<>=^"
_PUNCT = "(),.;[]"


class Tokenizer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def tokenize(self) -> List[Token]:
        out: List[Token] = []
        while True:
            t = self._next()
            out.append(t)
            if t.kind == "eof":
                return out

    def _peek_ch(self, off: int = 0) -> str:
        p = self.pos + off
        return self.text[p] if p < len(self.text) else ""

    def _next(self) -> Token:
        text, n = self.text, len(self.text)
        while self.pos < n and text[self.pos].isspace():
            self.pos += 1
        # comments
        if text.startswith("--", self.pos):
            while self.pos < n and text[self.pos] != "\n":
                self.pos += 1
            return self._next()
        if text.startswith("/*", self.pos):
            end = text.find("*/", self.pos + 2)
            self.pos = n if end < 0 else end + 2
            return self._next()
        if self.pos >= n:
            return Token("eof", "", self.pos)
        start = self.pos
        ch = text[self.pos]
        # string literal
        if ch == "'":
            self.pos += 1
            buf = []
            while self.pos < n:
                c = text[self.pos]
                if c == "'":
                    if self._peek_ch(1) == "'":  # escaped quote
                        buf.append("'")
                        self.pos += 2
                        continue
                    self.pos += 1
                    return Token("string", "".join(buf), start)
                buf.append(c)
                self.pos += 1
            raise ValueError(f"unterminated string literal at {start}")
        # quoted identifier
        if ch == '"' or ch == "`":
            quote = ch
            self.pos += 1
            end = text.find(quote, self.pos)
            if end < 0:
                raise ValueError(f"unterminated quoted identifier at {start}")
            val = text[self.pos:end]
            self.pos = end + 1
            return Token("ident", val, start)
        # number
        if ch.isdigit() or (ch == "." and self._peek_ch(1).isdigit()):
            p = self.pos
            seen_dot = False
            seen_e = False
            while p < n:
                c = text[p]
                if c.isdigit():
                    p += 1
                elif c == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    p += 1
                elif c in "eE" and not seen_e and p + 1 < n and (text[p + 1].isdigit() or text[p + 1] in "+-"):
                    seen_e = True
                    p += 1
                    if text[p] in "+-":
                        p += 1
                else:
                    break
            val = text[self.pos:p]
            self.pos = p
            return Token("number", val, start)
        # identifier / keyword
        if ch.isalpha() or ch == "_":
            p = self.pos
            while p < n and (text[p].isalnum() or text[p] == "_"):
                p += 1
            val = text[self.pos:p]
            self.pos = p
            return Token("ident", val, start)
        # multi-char operators
        for m in _MULTI_OPS:
            if text.startswith(m, self.pos):
                self.pos += len(m)
                return Token("op", m, start)
        if ch in _SINGLE_OPS:
            self.pos += 1
            return Token("op", ch, start)
        if ch in _PUNCT:
            self.pos += 1
            return Token("punct", ch, start)
        raise ValueError(f"unexpected character {ch!r} at position {self.pos}")


def tokenize(text: str) -> List[Token]:
    return Tokenizer(text).tokenize()
