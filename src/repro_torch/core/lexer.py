"""Tokenizer for the StarPlat language."""
from __future__ import annotations

import dataclasses
from typing import List

KEYWORDS = {
    "function", "forall", "for", "in", "filter", "fixedPoint", "until",
    "iterateInBFS", "iterateInReverse", "from", "do", "while", "if", "else",
    "return", "True", "False", "INF", "Min", "Max",
    "Graph", "node", "edge", "propNode", "propEdge", "SetN", "SetE",
    "int", "bool", "long", "float", "double",
}

# longest-match first
SYMBOLS = [
    "&&=", "||=", "<=", ">=", "==", "!=", "&&", "||", "+=", "-=", "*=", "/=",
    "++", "--", "(", ")", "{", "}", "[", "]", "<", ">", "=", "+", "-", "*",
    "/", "%", ".", ",", ";", ":", "!",
]


@dataclasses.dataclass
class Token:
    kind: str      # 'kw' | 'id' | 'int' | 'float' | 'sym' | 'eof'
    value: str
    line: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


class LexError(Exception):
    pass


def tokenize(src: str) -> List[Token]:
    toks: List[Token] = []
    i, line, n = 0, 1, len(src)
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i)
            if j < 0:
                raise LexError(f"line {line}: unterminated comment")
            line += src.count("\n", i, j)
            i = j + 2
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            toks.append(Token("kw" if word in KEYWORDS else "id", word, line))
            i = j
            continue
        if c.isdigit():
            j = i
            while j < n and src[j].isdigit():
                j += 1
            if j < n and src[j] == "." and j + 1 < n and src[j + 1].isdigit():
                j += 1
                while j < n and src[j].isdigit():
                    j += 1
                if j < n and src[j] in "eE":
                    j += 1
                    if j < n and src[j] in "+-":
                        j += 1
                    while j < n and src[j].isdigit():
                        j += 1
                toks.append(Token("float", src[i:j], line))
            else:
                toks.append(Token("int", src[i:j], line))
            i = j
            continue
        for sym in SYMBOLS:
            if src.startswith(sym, i):
                toks.append(Token("sym", sym, line))
                i += len(sym)
                break
        else:
            raise LexError(f"line {line}: unexpected character {c!r}")
    toks.append(Token("eof", "", line))
    return toks
