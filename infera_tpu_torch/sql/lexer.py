"""SQL lexer: a small hand-written scanner for the engine's SQL dialect."""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import SqlError


@dataclass
class Token:
    kind: str  # IDENT | NUMBER | STRING | OP | EOF
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


_TWO_CHAR_OPS = {"::", "<=", ">=", "<>", "!=", "||", "=="}
_ONE_CHAR_OPS = set("+-*/%=<>(),.;[]?")


def tokenize(sql: str) -> list:
    tokens: list = []
    i = 0
    n = len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":  # block comment
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlError("Parser Error: unterminated block comment")
            i = j + 2
            continue
        if c == "'":  # string literal, '' escapes a quote
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlError("Parser Error: unterminated string literal")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':  # quoted identifier
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError("Parser Error: unterminated quoted identifier")
            tokens.append(Token("IDENT", sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    sql[j + 1].isdigit() or sql[j + 1] in "+-"
                ):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            tokens.append(Token("NUMBER", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            tokens.append(Token("IDENT", sql[i:j], i))
            i = j
            continue
        if sql[i : i + 2] in _TWO_CHAR_OPS:
            tokens.append(Token("OP", sql[i : i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS or c == "!":
            tokens.append(Token("OP", c, i))
            i += 1
            continue
        raise SqlError(f"Parser Error: unexpected character '{c}' at position {i}")
    tokens.append(Token("EOF", "", n))
    return tokens
