"""A standard-library reader and writer for the YAML that the repo uses.

:func:`loads` / :func:`load` read the subset of YAML that ``configs/*.yaml``
and the run directories' ``config.yaml`` are written in, into the values
``yaml.safe_load`` gives for them:

- block mappings and block sequences (a sequence under a key may sit at
  the key's own indentation), nested by indentation;
- flow mappings (``{dim: 768, depth: 12}``) and flow sequences
  (``[1024, 4]``), nested, on one line or continued over several;
- comments, blank lines and a leading ``---``;
- plain, single-quoted and double-quoted scalars.

Plain scalars (keys too) resolve as PyYAML's YAML 1.1 resolver does: a
float needs a dot or an exponent with a sign after a mantissa with a dot
(``1.0e-4`` is a float, ``1e-4`` a string), ``yes`` / ``no`` / ``on`` /
``off`` / ``true`` / ``false`` in three spellings are booleans, ``~`` /
``null`` / an empty value is None, and integers take ``0x``, ``0b``, a
leading ``0`` (octal), ``_`` separators and base 60. What the subset
does not hold (anchors, aliases, tags, block scalars, timestamps) raises
``ValueError`` rather than read as something else.

:func:`dumps` / :func:`dump` write dicts, lists, tuples, strings, numbers,
booleans and None in block style; ``yaml.safe_load`` (and :func:`loads`)
read the text back to the same value.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), for plain scalars only
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = {"", "~", "null", "Null", "NULL"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_MERGE_OR_VALUE = {"<<", "="}


def _sexagesimal(digits: str, cast) -> Any:
    value = cast(0)
    for part in digits.split(":"):
        value = value * 60 + cast(part)
    return value


def _yaml_int(text: str) -> int:
    """PyYAML's ``construct_yaml_int``."""
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _yaml_float(text: str) -> float:
    """PyYAML's ``construct_yaml_float``."""
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """The value ``yaml.safe_load`` gives the plain scalar ``text``."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _yaml_int(text)
    if _FLOAT.match(text):
        return _yaml_float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f"YAML timestamp {text!r}: not in the supported "
                         f"subset (quote it)")
    if text in _MERGE_OR_VALUE:
        raise ValueError(f"YAML merge / value key {text!r}: not supported")
    return text


# -- reading ------------------------------------------------------------------

_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("indent", "text", "number")

    def __init__(self, indent: int, text: str, number: int) -> None:
        self.indent, self.text, self.number = indent, text, number


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes), right-stripped."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "\"'" and (i == 0 or text[i - 1] in " \t[{,:-?"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


class _Reader:
    def __init__(self, source: str) -> None:
        self.lines: List[_Line] = []
        for number, raw in enumerate(source.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError(f"line {number}: tab in indentation")
            text = _strip_comment(raw)
            stripped = text.lstrip(" ")
            if not stripped:
                continue
            if stripped in ("---", "...") and len(text) == len(stripped):
                if self.lines and stripped == "---":
                    raise ValueError(f"line {number}: a second document")
                continue
            self.lines.append(_Line(len(text) - len(stripped), stripped,
                                    number))
        self.pos = 0

    def error(self, msg: str, line: Optional[_Line] = None) -> ValueError:
        line = line or (self.lines[self.pos] if self.pos < len(self.lines)
                        else None)
        where = f"line {line.number}: " if line else ""
        return ValueError(f"{where}{msg}")

    # a node that starts on line ``self.pos`` at ``indent``
    def node(self, indent: int) -> Any:
        line = self.lines[self.pos]
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(line.indent)
        if self.key_split(line.text) is not None:
            return self.mapping(line.indent)
        value = self.inline_value(line.text, line)
        self.pos += 1
        return value

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise self.error("bad indentation in a sequence", line)
            if not (line.text == "-" or line.text.startswith("- ")):
                break
            rest = line.text[1:].lstrip(" ")
            if not rest:
                self.pos += 1
                out.append(self.child(indent, allow_same=False))
                continue
            # the item's content starts after "- ": treat it as a line of
            # its own at that column
            col = line.indent + len(line.text) - len(rest)
            self.lines[self.pos] = _Line(col, rest, line.number)
            out.append(self.node(col))
        return out

    def child(self, indent: int, allow_same: bool) -> Any:
        """The block under a key or a bare "-" at ``indent``, or None."""
        if self.pos >= len(self.lines):
            return None
        nxt = self.lines[self.pos]
        if nxt.indent > indent:
            return self.node(nxt.indent)
        if allow_same and nxt.indent == indent and (
                nxt.text == "-" or nxt.text.startswith("- ")):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise self.error("bad indentation in a mapping", line)
            split = self.key_split(line.text)
            if split is None:
                break
            key_text, rest = split
            key = self.inline_value(key_text, line)
            if rest:
                value = self.inline_value(rest, line)
                self.pos += 1
            else:
                self.pos += 1
                value = self.child(indent, allow_same=True)
            out[key] = value
        return out

    @staticmethod
    def key_split(text: str) -> Optional[Tuple[str, str]]:
        """(key text, rest) when ``text`` is a mapping entry ``key: rest``,
        else None."""
        if text[0] in "\"'":
            end = _quoted_end(text, 0)
            if end is None:
                return None
            after = text[end:]
            if after == ":" or after.startswith(": "):
                return text[:end], after[1:].strip()
            return None
        if text[0] in "[{":
            return None
        for m in re.finditer(r":(?=\s|$)", text):
            return text[:m.start()].rstrip(), text[m.end():].strip()
        return None

    def inline_value(self, text: str, line: _Line) -> Any:
        """A scalar or a flow collection written inline (flow collections
        continue over the following lines until they close)."""
        if text[0] in "[{":
            while True:
                try:
                    value, end = _Flow(text).parse()
                except _Unclosed:
                    if self.pos + 1 >= len(self.lines):
                        raise self.error("unclosed flow collection", line)
                    self.pos += 1
                    text = text + " " + self.lines[self.pos].text
                    continue
                if text[end:].strip():
                    raise self.error(f"text after a flow collection: "
                                     f"{text[end:]!r}", line)
                return value
        if text[0] in "&*!|>%@`":
            raise self.error(f"{text[0]!r}: anchors, aliases, tags and "
                             f"block scalars are not supported", line)
        if text[0] in "\"'":
            end = _quoted_end(text, 0)
            if end is None or text[end:].strip():
                raise self.error(f"bad quoted scalar {text!r}", line)
            return _unquote(text[:end])
        try:
            return resolve_plain(text.strip())
        except ValueError as e:
            raise self.error(str(e), line) from None


class _Unclosed(Exception):
    pass


def _quoted_end(text: str, start: int) -> Optional[int]:
    """The index after the quoted scalar that starts at ``start``."""
    q = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if q == '"' and c == "\\":
            i += 2
            continue
        if c == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    return None


def _unquote(token: str) -> str:
    body = token[1:-1]
    if token[0] == "'":
        return body.replace("''", "'")
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _DQ_ESCAPES:
            out.append(_DQ_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"unknown escape \\{e} in {token!r}")
    return "".join(out)


class _Flow:
    """A flow collection's parser over one string."""

    def __init__(self, text: str) -> None:
        self.text, self.i = text, 0

    def parse(self) -> Tuple[Any, int]:
        value = self.value()
        return value, self.i

    def skip(self) -> None:
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1
        if self.i >= len(self.text):
            raise _Unclosed()

    def value(self) -> Any:
        self.skip()
        c = self.text[self.i]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in "\"'":
            end = _quoted_end(self.text, self.i)
            if end is None:
                raise _Unclosed()
            token = self.text[self.i:end]
            self.i = end
            return _unquote(token)
        if c in "&*!|>":
            raise ValueError(f"{c!r} in a flow collection: not supported")
        start = self.i
        while self.i < len(self.text):
            ch = self.text[self.i]
            if ch in ",]}":
                break
            if ch == ":" and (self.i + 1 == len(self.text)
                              or self.text[self.i + 1] in " ,]}"):
                break
            self.i += 1
        return resolve_plain(self.text[start:self.i].strip())

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.text[self.i] == "]":
                self.i += 1
                return out
            out.append(self.value())
            self.skip()
            if self.text[self.i] == ",":
                self.i += 1
            elif self.text[self.i] != "]":
                raise ValueError(f"expected ',' or ']' in {self.text!r}")

    def map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip()
            if self.text[self.i] == "}":
                self.i += 1
                return out
            key = self.value()
            self.skip()
            if self.text[self.i] == ":":
                self.i += 1
                self.skip()
                value = (None if self.text[self.i] in ",}"
                         else self.value())
            else:
                value = None
            out[key] = value
            self.skip()
            if self.text[self.i] == ",":
                self.i += 1
            elif self.text[self.i] != "}":
                raise ValueError(f"expected ',' or '}}' in {self.text!r}")


def loads(source: str) -> Any:
    """The value of the YAML document ``source`` (None when empty)."""
    reader = _Reader(source)
    if not reader.lines:
        return None
    first = reader.lines[0]
    value = reader.node(first.indent)
    if reader.pos != len(reader.lines):
        raise reader.error("unexpected text after the document")
    return value


def load(path) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())


# -- writing ------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./()][^:#\n\r\t'\"]*$")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        # PyYAML's representer: YAML 1.1 floats need a dot in the mantissa
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        plain = (value == value.strip() and _PLAIN_SAFE.match(value)
                 and not value.endswith(":"))
        if plain:
            try:
                plain = resolve_plain(value) == value
            except ValueError:
                plain = False
        return value if plain else json.dumps(value, ensure_ascii=False)
    raise TypeError(f"cannot write {type(value).__name__} to YAML")


def _block(value: Any, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    if isinstance(value, dict):
        for k, v in value.items():
            key = _scalar(k)
            if isinstance(v, (dict, list, tuple)) and v:
                lines.append(f"{pad}{key}:")
                lines.extend(_block(v, indent + 2))
            else:
                lines.append(f"{pad}{key}: {_inline(v)}")
    else:
        for v in value:
            if isinstance(v, (dict, list, tuple)) and v:
                sub = _block(v, indent + 2)
                lines.append(f"{pad}- {sub[0][indent + 2:]}")
                lines.extend(sub[1:])
            else:
                lines.append(f"{pad}- {_inline(v)}")
    return lines


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def dumps(value: Any) -> str:
    """``value`` as block-style YAML text that ``yaml.safe_load`` reads
    back to the same value (tuples come back as lists)."""
    if isinstance(value, (dict, list, tuple)) and value:
        return "\n".join(_block(value, 0)) + "\n"
    return _inline(value) + "\n"


def dump(value: Any, path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps(value))
