"""A reader for the YAML subset of the repository's nested configs
(``egs/codec/mimi24k.yaml``, the configs ``yaml.safe_dump`` writes for the
tests, and GLM-4-Voice's hyperpyyaml ``config.yaml``), so the port needs no
YAML package.

It reads block mappings (nested by indentation), block sequences of
scalars or flow values, flow mappings and flow lists (``{lr: 2.0e-4,
betas: [0.8, 0.99]}``), quoted and plain scalars, and ``#`` comments. Plain
scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1: ``yes`` and
``on`` are true, ``2.0e-4`` is a float but ``1e-4`` a string).

Three hyperpyyaml tags are read, on a block mapping's value or a block
sequence's item, as the JAX decoder's loader maps them, and nothing is
run: ``!new:pkg.Class`` on a mapping (indented below, or a flow mapping)
gives ``{"_class": "pkg.Class", **mapping}``, on anything else
``{"_class": "pkg.Class"}``; ``!name:x`` gives the string ``x`` (a value
under it is read and dropped); ``!ref <k>`` gives the scalar text
``<k>``. Anything else (other tags such as ``!apply:``, tags inside flow
collections, anchors, aliases, block scalars, documents, sequences of
mappings) raises ``ValueError``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
# YAML 1.1 octal, hex, binary and sexagesimal numbers
_OTHER_NUMBER = re.compile(r"[-+]?(0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[0-9][0-9_]*(:[0-5]?[0-9])+"
                           r"(\.[0-9_]*)?)$")


def _scalar(text: str) -> Any:
    text = text.strip()
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"unsupported YAML construct: {text!r}")
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, 0)
        if text[rest:].strip():
            raise ValueError(f"text after a quoted scalar: {text!r}")
        return value
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _OTHER_NUMBER.match(text):
        raise ValueError(f"unsupported YAML number: {text!r}")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "-.", "+."):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _quoted(text: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at ``text[i]`` and the index after it."""
    quote, out, i = text[i], [], i + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            esc = text[i + 1: i + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, "\\" + esc))
            i += 2
            continue
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


class _Flow:
    """Recursive descent over one flow value (``{...}`` or ``[...]``)."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def _skip(self):
        while self.i < len(self.text) and self.text[self.i] == " ":
            self.i += 1

    def value(self, stops: str) -> Any:
        self._skip()
        c = self.text[self.i: self.i + 1]
        if c == "{":
            return self._mapping()
        if c == "[":
            return self._sequence()
        if c in ("'", '"'):
            v, self.i = _quoted(self.text, self.i)
            return v
        start = self.i
        while self.i < len(self.text) and self.text[self.i] not in stops:
            self.i += 1
        return _scalar(self.text[start: self.i])

    def _expect(self, chars: str) -> str:
        self._skip()
        c = self.text[self.i: self.i + 1]
        if not c or c not in chars:
            raise ValueError(f"expected one of {chars!r} at {self.i} in {self.text!r}")
        self.i += 1
        return c

    def _mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        self._skip()
        if self.text[self.i: self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.value(":,}")
            self._expect(":")
            out[key] = self.value(",}")
            if self._expect(",}") == "}":
                return out

    def _sequence(self) -> list:
        self.i += 1
        out: list = []
        self._skip()
        if self.text[self.i: self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value(",]"))
            if self._expect(",]") == "]":
                return out

    def parse(self) -> Any:
        v = self.value("")
        self._skip()
        if self.i != len(self.text):
            raise ValueError(f"text after a flow value: {self.text!r}")
        return v


def _value(text: str) -> Any:
    text = text.strip()
    tag = _tag(text)
    if tag is not None:
        return _tagged(*tag)
    if text[:1] in ("{", "["):
        return _Flow(text).parse()
    return _scalar(text)


_TAG = re.compile(r"!(new:|name:|ref(?=\s|$))(\S*)\s*(.*)$")


def _tag(text: str):
    """(kind, suffix, the text after the tag) of a hyperpyyaml tag starting
    ``text``, or None when it starts with none."""
    if not text.startswith("!"):
        return None
    m = _TAG.match(text)
    if m is None:
        raise ValueError(f"unsupported YAML tag: {text!r}")
    return m.group(1).rstrip(":"), m.group(2), m.group(3)


def _tagged(kind: str, suffix: str, rest: str, block: Any = None) -> Any:
    """The value of a tagged node: ``rest`` the text after the tag on its
    line, ``block`` the indented value below it (None when there is none)."""
    if kind == "name":
        return suffix
    if kind == "ref":
        if block is not None:
            raise ValueError(f"!ref on a collection: {block!r}")
        if rest[:1] in ("'", '"'):
            value, end = _quoted(rest, 0)
            if rest[end:].strip():
                raise ValueError(f"text after a quoted scalar: {rest!r}")
            return value
        return rest
    value = _value(rest) if rest else block
    return {**value, "_class": suffix} if isinstance(value, dict) else {"_class": suffix}


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"'):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str, where: str) -> tuple[Any, str]:
    """``key: rest`` -> (key, rest)."""
    if text[:1] in ("'", '"'):
        key, i = _quoted(text, 0)
        rest = text[i:]
        if not rest.startswith(":"):
            raise ValueError(f"{where}: expected ':' after a quoted key")
        return key, rest[1:]
    m = re.match(r"([^:]+?):(\s|$)", text)
    if m is None:
        raise ValueError(f"{where}: not a `key: value` line: {text!r}")
    return _scalar(m.group(1)), text[m.end(1) + 1:]


def loads(text: str) -> Any:
    """The value of a YAML document in the supported subset."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.startswith(("---", "...")):
            raise ValueError(f"line {n}: YAML documents are not supported")
        lines.append((len(line) - len(line.lstrip()), line.strip(), n))
    if not lines:
        return None
    if lines[0][1][:1] in ("{", "["):  # a flow document (JSON among them)
        return _Flow(" ".join(text for _, text, _ in lines)).parse()
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"line {lines[end][2]}: unexpected indentation")
    return value


def _block(lines: list, i: int, indent: int) -> tuple[Any, int]:
    if lines[i][1].startswith("-"):
        return _sequence(lines, i, indent)
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent and not lines[i][1].startswith("- "):
        _, text, n = lines[i]
        key, rest = _split_key(text, f"line {n}")
        if key in out:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        i += 1
        tag = _tag(rest.strip())
        if tag is not None and not tag[2]:
            block = None
            if i < len(lines) and lines[i][0] > indent:
                block, i = _block(lines, i, lines[i][0])
            elif i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("- "):
                block, i = _sequence(lines, i, indent)
            out[key] = _tagged(*tag, block)
        elif rest.strip():
            out[key] = _value(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        elif i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("- "):
            out[key], i = _sequence(lines, i, indent)
        else:
            out[key] = None
    return out, i


def _sequence(lines: list, i: int, indent: int) -> tuple[list, int]:
    out = []
    while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("-"):
        _, text, n = lines[i]
        item = text[1:].strip()
        if not text.startswith("- ") or not item:
            raise ValueError(f"line {n}: only `- value` sequence items are supported")
        if re.match(r"[^'\"{\[][^:]*:(\s|$)", item):
            raise ValueError(f"line {n}: sequences of mappings are not supported")
        out.append(_value(item))
        i += 1
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"line {lines[i][2]}: nested block under a sequence item")
    return out, i


def load(path: str | Path) -> Any:
    return loads(Path(path).read_text(encoding="utf-8"))

