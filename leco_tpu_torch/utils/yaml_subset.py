"""A reader for the YAML subset the repo's config and prompt files use.

The machine the port targets has no PyYAML, so `config.py` and `prompts.py`
read their files with `loads` here. The subset:

  * block mappings (`key: value`, `key:` followed by a nested block) and
    block sequences (`- item`, `- key: value` starting a mapping item),
    nested by indentation (spaces only);
  * one-line flow mappings `{ k: v, ... }` and flow sequences `[a, b]`;
  * double- and single-quoted scalars, plain scalars, empty values;
  * `#` comments, whole-line or after whitespace.

Plain scalars resolve as PyYAML's `safe_load` resolves them (YAML 1.1):
null (`~`, `null`, empty), bool (`true`, `yes`, `on`, ... in three cases),
int (decimal, `0x`, `0b`, a leading `0` is octal, `_` separators) and float
(a dot is required: `1e-4` stays the string "1e-4", and the config layer
coerces it). Anything outside the subset — anchors, aliases, tags, block
scalars, documents markers, multi-line scalars, timestamps, sexagesimal
numbers — raises `YAMLSubsetError` naming its line.
"""

from __future__ import annotations

import dataclasses
import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's implicit resolvers (resolver.py), sexagesimal forms split out
_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
)
_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?")
# first characters that start a construct outside the subset
_UNSUPPORTED_START = {"&": "an anchor", "*": "an alias", "!": "a tag",
                      "|": "a block scalar", ">": "a block scalar",
                      "%": "a directive", "@": "a reserved indicator",
                      "`": "a reserved indicator", "?": "a complex key"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YAMLSubsetError(ValueError):
    pass


@dataclasses.dataclass
class _Line:
    number: int  # 1-based, for messages
    indent: int
    text: str  # without indentation and comment


def _fail(line: int, what: str):
    raise YAMLSubsetError(f"line {line}: {what}")


def _strip_comment(text: str, number: int) -> str:
    """Drop a `#` comment that starts the text or follows whitespace, outside
    quotes."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == '"' and c == "\\":
            i += 2
            continue
        if quote:
            if c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "\"'" and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote:
        _fail(number, "a quoted scalar that does not end on its line")
    return text.rstrip()


def _lines(text: str) -> list[_Line]:
    out = []
    for number, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            _fail(number, "a tab in the indentation")
        body = _strip_comment(body, number)
        if not body:
            continue
        if number == 1 and body.startswith("﻿"):
            body = body[1:]
        if body.startswith(("---", "...")) and body[3:4] in ("", " "):
            _fail(number, "a document marker")
        out.append(_Line(number, len(raw) - len(raw.lstrip(" ")), body))
    return out


# ---------------------------------------------------------------------------
# scalars
# ---------------------------------------------------------------------------


def _resolve_plain(text: str, number: int):
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value != "0" and value.startswith("0"):
            return sign * int(value, 8)
        return sign * int(value)
    if _FLOAT.fullmatch(text):
        value = text.replace("_", "").lower()
        if value.endswith(".inf"):
            return float("-inf") if value[0] == "-" else float("inf")
        if value == ".nan":
            return float("nan")
        return float(value)
    if _SEXAGESIMAL.fullmatch(text):
        _fail(number, f"a sexagesimal number {text!r}")
    if _TIMESTAMP.fullmatch(text):
        _fail(number, f"a timestamp {text!r}")
    if text == "<<":
        _fail(number, "a merge key")
    return text


def _double_quoted(text: str, start: int, number: int) -> tuple[str, int]:
    """-> (value, index after the closing quote)."""
    out = []
    i = start + 1
    while i < len(text):
        c = text[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    _fail(number, f"a bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                _fail(number, f"an unknown escape \\{e}")
            continue
        out.append(c)
        i += 1
    _fail(number, "a double-quoted scalar that does not end on its line")


def _single_quoted(text: str, start: int, number: int) -> tuple[str, int]:
    out = []
    i = start + 1
    while i < len(text):
        c = text[i]
        if c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(c)
        i += 1
    _fail(number, "a single-quoted scalar that does not end on its line")


def _value(text: str, number: int):
    """A whole value on one line: a scalar or a flow collection."""
    text = text.strip()
    if text[:1] in "[{":
        value, end = _flow(text, 0, number)
        if text[end:].strip():
            _fail(number, f"text after a flow collection: {text[end:]!r}")
        return value
    if text[:1] in "\"'":
        quoted = _double_quoted if text[0] == '"' else _single_quoted
        value, end = quoted(text, 0, number)
        if text[end:].strip():
            _fail(number, f"text after a quoted scalar: {text[end:]!r}")
        return value
    if text[:1] in _UNSUPPORTED_START:
        _fail(number, f"{_UNSUPPORTED_START[text[0]]} ({text!r})")
    if text.startswith("- ") or text == "-":
        _fail(number, "a block sequence where a value was expected")
    if ": " in text or text.endswith(":"):
        _fail(number, f"a mapping inside a plain scalar ({text!r})")
    return _resolve_plain(text, number)


# ---------------------------------------------------------------------------
# flow collections (one line)
# ---------------------------------------------------------------------------


def _skip_spaces(text: str, i: int) -> int:
    while i < len(text) and text[i] == " ":
        i += 1
    return i


def _flow_scalar(text: str, i: int, number: int, stops: str):
    """A scalar inside a flow collection, ending at one of `stops`."""
    if text[i:i + 1] in "\"'":
        quoted = _double_quoted if text[i] == '"' else _single_quoted
        return quoted(text, i, number)
    if text[i:i + 1] in _UNSUPPORTED_START:
        _fail(number, f"{_UNSUPPORTED_START[text[i]]} in a flow collection")
    j = i
    while j < len(text) and text[j] not in stops:
        if text[j] == ":" and ":" in stops and text[j + 1:j + 2] in (" ", ",", "}", ""):
            break
        j += 1
    return _resolve_plain(text[i:j].strip(), number), j


def _flow(text: str, i: int, number: int):
    """A `{...}` or `[...]` starting at text[i] -> (value, index after it)."""
    is_map = text[i] == "{"
    close = "}" if is_map else "]"
    out: dict | list = {} if is_map else []
    i = _skip_spaces(text, i + 1)
    while True:
        if i >= len(text):
            _fail(number, "a flow collection that does not end on its line")
        if text[i] == close:
            return out, i + 1
        if is_map:
            key, i = _flow_scalar(text, i, number, ",:}")
            i = _skip_spaces(text, i)
            value = None
            if text[i:i + 1] == ":":
                i = _skip_spaces(text, i + 1)
                if text[i:i + 1] in "[{" and i < len(text):
                    value, i = _flow(text, i, number)
                elif text[i:i + 1] not in (",", "}"):
                    value, i = _flow_scalar(text, i, number, ",}")
            out[key] = value
        else:
            if text[i] in "[{":
                item, i = _flow(text, i, number)
            else:
                item, i = _flow_scalar(text, i, number, ",]")
            out.append(item)
        i = _skip_spaces(text, i)
        if text[i:i + 1] == ",":
            i = _skip_spaces(text, i + 1)
        elif text[i:i + 1] != close:
            _fail(number, f"unexpected {text[i:i + 1]!r} in a flow collection")


# ---------------------------------------------------------------------------
# block collections
# ---------------------------------------------------------------------------


def _split_key(text: str, number: int):
    """`key: value` / `key:` -> (key, value text), or None if the line is
    not a mapping entry."""
    if text[:1] in "\"'":
        quoted = _double_quoted if text[0] == '"' else _single_quoted
        key, end = quoted(text, 0, number)
        rest = text[end:].lstrip(" ")
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:].strip()
    if text[:1] in "[{":
        return None
    for i, c in enumerate(text):
        if c == ":" and text[i + 1:i + 2] in ("", " "):
            key = text[:i].strip()
            if key[:1] in _UNSUPPORTED_START:
                _fail(number, f"{_UNSUPPORTED_START[key[0]]} as a key")
            return _resolve_plain(key, number), text[i + 1:].strip()
    return None


def _is_item(line: _Line) -> bool:
    return line.text == "-" or line.text.startswith("- ")


def _block(lines: list[_Line], i: int, indent: int):
    """The block starting at lines[i] (at `indent`) -> (value, next index)."""
    if _is_item(lines[i]):
        return _sequence(lines, i, indent)
    if _split_key(lines[i].text, lines[i].number) is None:
        # a lone scalar (a whole document, or the value of `key:` on its own
        # lines would be a multi-line scalar, which is outside the subset)
        if i + 1 < len(lines) and lines[i + 1].indent >= indent:
            _fail(lines[i + 1].number, "a multi-line scalar")
        return _value(lines[i].text, lines[i].number), i + 1
    return _mapping(lines, i, indent)


def _nested(lines: list[_Line], i: int, parent_indent: int, allow_same_seq: bool):
    """The value on the lines after a `key:` or `-` with nothing after it."""
    if i < len(lines):
        nxt = lines[i]
        if nxt.indent > parent_indent or (allow_same_seq and nxt.indent == parent_indent
                                          and _is_item(nxt)):
            return _block(lines, i, nxt.indent)
    return None, i


def _sequence(lines: list[_Line], i: int, indent: int):
    out = []
    while i < len(lines) and lines[i].indent == indent and _is_item(lines[i]):
        line = lines[i]
        rest = line.text[1:].lstrip(" ")
        if not rest:
            item, i = _nested(lines, i + 1, indent, False)
        else:
            col = indent + len(line.text) - len(rest)
            if _is_item(_Line(line.number, col, rest)) or _split_key(rest, line.number):
                # `- key: v` / `- - x`: the item is a block starting at `col`
                lines[i] = _Line(line.number, col, rest)
                item, i = _block(lines, i, col)
            else:
                item, i = _value(rest, line.number), i + 1
        out.append(item)
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].number, "bad indentation after a sequence item")
    return out, i


def _mapping(lines: list[_Line], i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        if _is_item(line):
            _fail(line.number, "a sequence item inside a mapping")
        entry = _split_key(line.text, line.number)
        if entry is None:
            _fail(line.number, f"expected `key: value`, got {line.text!r}")
        key, rest = entry
        if rest:
            out[key], i = _value(rest, line.number), i + 1
        else:
            out[key], i = _nested(lines, i + 1, indent, True)
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].number, "bad indentation")
    return out, i


def loads(text: str):
    """YAML text in the subset -> Python value (None for an empty file)."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0].indent)
    if i != len(lines):
        _fail(lines[i].number, "text after the end of the document's block")
    return value


def load(path) -> object:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
