"""SQL lexer for the engine's SQL dialect.

An ASCII text is cut into tokens by one compiled regular expression; a text
that holds any other character goes through the per-character scanner, whose
``str.isalpha``/``str.isdigit`` rules the expression cannot match outside
ASCII. Both give the same tokens and the same errors on ASCII text."""

from __future__ import annotations

import re

from ..errors import SqlError


# A token is a tuple (kind, text, pos, upper), the cheapest object to make and
# to read: its kind (IDENT, NUMBER, STRING, OP or EOF), its text (a string's
# without its quotes and escapes, a quoted identifier's without its quotes),
# its offset in the statement, and its text upper-cased, computed once.
KIND, TEXT, POS, UPPER = range(4)
Token = tuple


_TWO_CHAR_OPS = {"::", "<=", ">=", "<>", "!=", "||", "=="}
_ONE_CHAR_OPS = set("+-*/%=<>(),.;[]?")

# One match a token: group 1 is what is skipped before it (whitespace and
# closed comments); then the token is an identifier (group 2), one of the
# commonest operators (group 3), or anything else (group 4). Group 4's
# alternatives are tried in order, so a number beats the "." operator and
# "/*" the "/"; a lone quote, an unclosed "/*" or any other character falls
# to its one-character catch-all and is reported, and its empty match at the
# end of the text stands for EOF. The possessive quantifiers keep a string's
# '' escapes and the skipped run from giving characters back.
_TOKEN_RE = re.compile(
    r"([ \t\r\n]*+(?:(?:--[^\n]*\n?|/\*(?s:.*?)\*/)[ \t\r\n]*+)*+)"
    r"(?:([A-Za-z_][A-Za-z0-9_]*)|([(),])|("
    r"(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE](?:[+-][0-9]*|[0-9]+))?"
    r"|/\*"
    r"|::|<=|>=|<>|!=|\|\||==|[-+*/%=<>.;\[\]?!]"
    r"|'[^']*+(?:''[^']*+)*+'"
    r"|\"[^\"]*\""
    r"|(?s:.)"
    r"|))")

# the kind of group 4's text by its first character; "" is the end of the text
_FIRST = {c: "NUMBER" for c in "0123456789"}
_FIRST.update({c: "OP" for c in "+-*%=<>;[]?!"})
_FIRST.update({".": "DOT", "/": "SLASH", ":": "PAIR", "|": "PAIR", "'": "STRING",
               '"': "QUOTED", "": "EOF"})


def tokenize(sql: str) -> list:
    if not sql.isascii():
        return _tokenize_chars(sql)
    tokens: list = []
    append = tokens.append
    pos = 0
    for skip, ident, punct, text in _TOKEN_RE.findall(sql):
        pos += len(skip)
        if ident:
            append(("IDENT", ident, pos, ident.upper()))
            pos += len(ident)
            continue
        if punct:
            append(("OP", punct, pos, punct))
            pos += 1
            continue
        kind = _FIRST.get(text[:1])
        if kind == "OP":
            append(("OP", text, pos, text))
        elif kind == "NUMBER":
            append(("NUMBER", text, pos, text.upper()))
        elif kind == "STRING":
            if len(text) == 1:
                raise SqlError("Parser Error: unterminated string literal")
            s = text[1:-1].replace("''", "'")
            append(("STRING", s, pos, s.upper()))
        elif kind == "EOF":
            append(("EOF", "", len(sql), ""))
            return tokens
        elif kind == "QUOTED":
            if len(text) == 1:
                raise SqlError("Parser Error: unterminated quoted identifier")
            s = text[1:-1]
            append(("IDENT", s, pos, s.upper()))
        elif kind == "DOT":
            append(("NUMBER", text, pos, text.upper()) if len(text) > 1
                   else ("OP", text, pos, text))
        elif kind == "SLASH":
            if text == "/*":
                raise SqlError("Parser Error: unterminated block comment")
            append(("OP", text, pos, text))
        elif kind == "PAIR" and len(text) == 2:  # "::" or "||"; alone, ":" and "|" are not
            append(("OP", text, pos, text))
        else:
            raise SqlError(f"Parser Error: unexpected character '{text}' at position {pos}")
        pos += len(text)
    raise AssertionError("the token expression always ends with an empty match")


def _tokenize_chars(sql: str) -> list:
    """The per-character scanner, for text outside ASCII."""
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
            s = "".join(buf)
            tokens.append(("STRING", s, i, s.upper()))
            i = j + 1
            continue
        if c == '"':  # quoted identifier
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError("Parser Error: unterminated quoted identifier")
            s = sql[i + 1 : j]
            tokens.append(("IDENT", s, i, s.upper()))
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
            s = sql[i:j]
            tokens.append(("NUMBER", s, i, s.upper()))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            s = sql[i:j]
            tokens.append(("IDENT", s, i, s.upper()))
            i = j
            continue
        if sql[i : i + 2] in _TWO_CHAR_OPS:
            tokens.append(("OP", sql[i : i + 2], i, sql[i : i + 2]))
            i += 2
            continue
        if c in _ONE_CHAR_OPS or c == "!":
            tokens.append(("OP", c, i, c))
            i += 1
            continue
        raise SqlError(f"Parser Error: unexpected character '{c}' at position {i}")
    tokens.append(("EOF", "", n, ""))
    return tokens
