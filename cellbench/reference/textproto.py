"""A reader of protobuf text format, enough for the model files: scalars
(numbers, quoted strings, enum names, true/false), nested messages and
repeated fields, `#` comments. It knows no schema: every field becomes a
list of values under its name, and the reference gives the defaults."""

from __future__ import annotations

import re
from typing import Dict, List, Union

Value = Union[str, float, int, bool, "Message"]
Message = Dict[str, List[Value]]

_TOKEN = re.compile(r'\s+|#[^\n]*|"(?:[^"\\]|\\.)*"|[{}:]|[^\s{}:"#]+')


def _tokens(text: str) -> List[str]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"cannot read the text at {text[pos:pos + 20]!r}")
        tok = m.group(0)
        pos = m.end()
        if not tok.isspace() and not tok.startswith("#"):
            out.append(tok)
    return out


def _scalar(tok: str) -> Value:
    if tok.startswith('"'):
        return bytes(tok[1:-1], "utf-8").decode("unicode_escape")
    if tok in ("true", "false"):
        return tok == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok  # an enum's name


def parse(text: str) -> Message:
    """The message in `text` as {field: [values]}, nested messages as
    dicts of the same form."""
    toks = _tokens(text)
    pos = 0

    def message(closing: bool) -> Message:
        nonlocal pos
        msg: Message = {}
        while pos < len(toks):
            name = toks[pos]
            if name == "}":
                if not closing:
                    raise ValueError("unbalanced '}'")
                pos += 1
                return msg
            pos += 1
            if pos < len(toks) and toks[pos] == ":":
                pos += 1
            if pos >= len(toks):
                raise ValueError(f"field {name!r} has no value")
            if toks[pos] == "{":
                pos += 1
                msg.setdefault(name, []).append(message(True))
            else:
                msg.setdefault(name, []).append(_scalar(toks[pos]))
                pos += 1
        if closing:
            raise ValueError("a message is not closed")
        return msg

    return message(False)
