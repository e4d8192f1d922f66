"""A YAML reader and writer for config files, in pure Python.

`loads` reads the subset of YAML that the configs under `egs/` and
`yaml.safe_dump(..., sort_keys=True)` use, and gives what `yaml.safe_load`
gives for it:

- block mappings and block sequences, nested by indentation, with
  sequences indented or not under their key, and compact nesting
  (`- a: 1`, `- - x`);
- flow sequences and flow mappings on one line (`[0, 0, 0]`, `{}`);
- scalars continued over lines;
- comments, on their own line or after a value;
- plain scalars, single-quoted (`''` is a quote) and double-quoted
  strings (with YAML's escapes);
- plain scalars resolved as PyYAML's YAML 1.1 resolver does: `1.0e-8` is a
  float and `1e-8` a string; yes/no/on/off/true/false in three cases are
  bools; `~`, `null` and an empty value are None; `0x1f`, `0o`-less octal
  `017`, `0b101` and sexagesimal `1:30` are ints.

Plain and quoted scalars may go on over lines, folded as PyYAML folds them
(a line break is a space, each empty line a newline; a backslash at the
end of a double-quoted line joins). Anything else (anchors, aliases,
tags, block scalars, multi-line flow collections, document markers,
timestamps, tabs in indentation, duplicate keys) raises `YAMLSyntaxError`
naming the file and line: the reader never guesses.

`dumps` writes a mapping in the layout of `yaml.safe_dump(...,
sort_keys=True)`: keys sorted, two-space nesting, sequences unindented
under their key, floats as PyYAML writes them, and strings plain only
where they read back as the same string (else quoted).
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple


class YAMLSyntaxError(ValueError):
    pass


# ---------------------------------------------------------------- scalars

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# PyYAML tries each resolver only on values starting with one of its characters
_FIRST = {"bool": set("yYnNtTfFoO"), "float": set("-+0123456789."), "int": set("-+0123456789"),
          "null": set("~nN"), "timestamp": set("0123456789")}


def _sexagesimal(value: str, cast):
    out = cast(0)
    for part in value.split(":"):
        out = out * 60 + cast(part)
    return out


def _int(value: str) -> int:
    v = value.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _float(value: str) -> float:
    v = value.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def resolve_plain(value: str, where: str = "") -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 implicit resolvers."""
    first = value[:1]
    if first in _FIRST["bool"] and _BOOL.match(value):
        return value.lower() in ("yes", "true", "on")
    if first in _FIRST["float"] and _FLOAT.match(value):
        return _float(value)
    if first in _FIRST["int"] and _INT.match(value):
        return _int(value)
    if value in ("<<", "="):
        raise YAMLSyntaxError(f"{where}: the YAML merge/value key {value!r} is not supported")
    if (first in _FIRST["null"] or value == "") and _NULL.match(value):
        return None
    if first in _FIRST["timestamp"] and _TIMESTAMP.match(value):
        raise YAMLSyntaxError(f"{where}: timestamps are not supported: {value!r}")
    return value


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Unterminated(YAMLSyntaxError):
    pass


def _fold(s: str, j: int, out: List[str], escaped: bool) -> int:
    """Fold the line break at s[j] inside a quoted scalar as PyYAML does:
    a break followed by n empty lines gives n newlines, a lone break a
    space (nothing after an escaping backslash); the next line's leading
    blanks go. Returns the index after them."""
    j += 1
    breaks = 0
    while True:
        while j < len(s) and s[j] in " \t":
            j += 1
        if j < len(s) and s[j] == "\n":
            breaks += 1
            j += 1
            continue
        break
    if s.startswith(("---", "..."), j) and (j == 0 or s[j - 1] == "\n"):
        raise YAMLSyntaxError("a document marker inside a quoted string")
    out.append("\n" * breaks if breaks else ("" if escaped else " "))
    return j


def _double_quoted(s: str, i: int, where: str) -> Tuple[str, int]:
    """The string starting at the quote s[i]; returns (value, index after)."""
    out: List[str] = []
    blanks = ""  # literal blanks, dropped before a line break
    j = i + 1
    while j < len(s):
        c = s[j]
        if c in " \t":
            blanks += c
            j += 1
            continue
        if c == "\n":
            blanks = ""
            j = _fold(s, j, out, escaped=False)
            continue
        out.append(blanks)
        blanks = ""
        if c == '"':
            return "".join(out), j + 1
        if c == "\\":
            e = s[j + 1:j + 2]
            if e == "":
                break
            if e == "\n":
                j = _fold(s, j + 1, out, escaped=True)
            elif e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                code = s[j + 2:j + 2 + n]
                if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                    raise YAMLSyntaxError(f"{where}: bad escape \\{e}{code}")
                out.append(chr(int(code, 16)))
                j += 2 + n
            else:
                raise YAMLSyntaxError(f"{where}: unknown escape \\{e}")
        else:
            out.append(c)
            j += 1
    raise _Unterminated(f"{where}: unterminated double-quoted string")


def _single_quoted(s: str, i: int, where: str) -> Tuple[str, int]:
    out: List[str] = []
    blanks = ""
    j = i + 1
    while j < len(s):
        c = s[j]
        if c in " \t":
            blanks += c
            j += 1
            continue
        if c == "\n":
            blanks = ""
            j = _fold(s, j, out, escaped=False)
            continue
        out.append(blanks)
        blanks = ""
        if c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise _Unterminated(f"{where}: unterminated single-quoted string")


def _quoted(s: str, i: int, where: str) -> Tuple[str, int]:
    return (_double_quoted if s[i] == '"' else _single_quoted)(s, i, where)


def _plain(text: str, where: str, flow: bool) -> Any:
    """A plain scalar (comments already removed), resolved."""
    v = text.strip()
    if not v:
        return None
    c = v[0]
    if c in "&*!|>%@`":
        raise YAMLSyntaxError(f"{where}: {v!r}: anchors, aliases, tags, block scalars and directives "
                              "are not supported")
    if c in "-?:" and (len(v) == 1 or v[1] == " "):
        raise YAMLSyntaxError(f"{where}: {v!r} is not a scalar")
    if c in ",[]{}#":
        raise YAMLSyntaxError(f"{where}: {v!r} is not a plain scalar")
    if ": " in v or v.endswith(":") or " #" in v or "\t#" in v:
        raise YAMLSyntaxError(f"{where}: {v!r}: a mapping value is not allowed here")
    if flow and any(ch in v for ch in ",[]{}"):
        raise YAMLSyntaxError(f"{where}: {v!r} in a flow collection")
    return resolve_plain(v, where)


def _scalar_or_flow(text: str, where: str) -> Any:
    """A value written on one line: a flow collection, a quoted string or a
    plain scalar."""
    t = text.strip()
    if t[:1] in ("[", "{"):
        value, end = _flow(t, 0, where)
        if t[end:].strip():
            raise YAMLSyntaxError(f"{where}: {t[end:].strip()!r} after a flow collection")
        return value
    if t[:1] in ("'", '"'):
        value, end = _quoted(t, 0, where)
        if t[end:].strip():
            raise YAMLSyntaxError(f"{where}: {t[end:].strip()!r} after a quoted string")
        return value
    return _plain(t, where, flow=False)


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] == " ":
        i += 1
    return i


def _flow_item(s: str, i: int, where: str, stops: str) -> Tuple[Any, int]:
    i = _skip_ws(s, i)
    if i < len(s) and s[i] in "[{":
        return _flow(s, i, where)
    if i < len(s) and s[i] in "'\"":
        return _quoted(s, i, where)
    j = i
    while j < len(s) and s[j] not in stops and not (s[j] == ":" and s[j + 1:j + 2] in (" ", "", ",", "]", "}")):
        j += 1
    return _plain(s[i:j], where, flow=True), j


def _flow(s: str, i: int, where: str) -> Tuple[Any, int]:
    """The flow collection opening at s[i]; returns (value, index after)."""
    close = "]" if s[i] == "[" else "}"
    out: Any = [] if close == "]" else {}
    i += 1
    while True:
        i = _skip_ws(s, i)
        if i >= len(s):
            raise YAMLSyntaxError(f"{where}: unterminated flow collection (multi-line flow collections "
                                  "are not supported)")
        if s[i] == close:
            return out, i + 1
        item, i = _flow_item(s, i, where, ",]}" if close == "]" else ",}")
        i = _skip_ws(s, i)
        if close == "}":
            if i >= len(s) or s[i] != ":":
                raise YAMLSyntaxError(f"{where}: a flow mapping entry without ':'")
            value, i = _flow_item(s, i + 1, where, ",}")
            _set(out, item, value, where)
            i = _skip_ws(s, i)
        else:
            if i < len(s) and s[i] == ":":
                raise YAMLSyntaxError(f"{where}: single-pair mappings in flow sequences are not supported")
            out.append(item)
        if i < len(s) and s[i] == ",":
            i += 1
        elif i >= len(s) or s[i] != close:
            raise YAMLSyntaxError(f"{where}: expected ',' or {close!r} in a flow collection")


def _set(mapping: dict, key, value, where: str):
    try:
        if key in mapping:
            raise YAMLSyntaxError(f"{where}: duplicate key {key!r}")
    except TypeError as exc:  # an unhashable key
        raise YAMLSyntaxError(f"{where}: key {key!r} is not hashable") from exc
    mapping[key] = value


# ---------------------------------------------------------------- block structure


def _strip_comment(line: str) -> str:
    """The line without its comment; quotes are honoured where a quoted
    scalar can start (the line's start, after ': ', '- ', '[', '{', ',')."""
    i, n = 0, len(line)
    token_start = True
    while i < n:
        c = line[i]
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        if token_start and c in "'\"":
            try:
                _, i = _quoted(line, i, "")
            except YAMLSyntaxError:
                return line  # unterminated: reported where the scalar is read
            token_start = False
            continue
        if c in " \t":
            i += 1
            continue
        token_start = c in "[{," or (c in "-:?" and line[i + 1:i + 2] in (" ", ""))
        i += 1
    return line.rstrip()


class _Line:
    __slots__ = ("indent", "text", "no", "raw")

    def __init__(self, indent: int, text: str, no: int, raw: str):
        # text: the line from column `indent`, without its comment; raw: with it
        self.indent, self.text, self.no, self.raw = indent, text, no, raw


def _key_split(text: str, where: str) -> Optional[Tuple[Any, str]]:
    """(key, rest) when `text` is a block mapping entry 'key: rest'."""
    if text[:1] in ("'", '"'):
        try:
            key, end = _quoted(text, 0, where)
        except _Unterminated:
            return None  # a quoted scalar going on over lines: not a key
        rest = text[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return key, rest[1:]
        return None
    if text[:1] in ("[", "{"):
        return None
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None
    key = text[:m.start()]
    if key.strip() in ("", "?") or key.startswith("? "):
        raise YAMLSyntaxError(f"{where}: complex mapping keys are not supported")
    return _plain(key, where, flow=False), text[m.end():]


class _Parser:
    def __init__(self, text: str, fname: str):
        self.fname = fname
        self.raw = [r.rstrip("\r") for r in text.split("\n")]
        self.lines: List[_Line] = []
        for no, raw in enumerate(self.raw, 1):
            body = raw.lstrip(" ")
            if body.startswith("\t") and body.strip():
                raise YAMLSyntaxError(f"{fname}:{no}: a tab in the indentation")
            text = _strip_comment(body)
            if not text.strip():
                continue
            if text.startswith(("---", "...", "%")) and (len(text) == 3 or text[3:4] in (" ", "")):
                raise YAMLSyntaxError(f"{fname}:{no}: document markers and directives are not supported")
            self.lines.append(_Line(len(raw) - len(body), text, no, body))

    def where(self, i: int) -> str:
        return f"{self.fname}:{self.lines[i].no}" if i < len(self.lines) else f"{self.fname}:end"

    def parse(self) -> Any:
        if not self.lines:
            return None
        value, i = self.node(0, self.lines[0].indent, -1)
        if i < len(self.lines):
            raise YAMLSyntaxError(f"{self.where(i)}: unexpected content {self.lines[i].text!r} (bad indentation?)")
        return value

    def _is_seq(self, i: int) -> bool:
        t = self.lines[i].text
        return t == "-" or t.startswith("- ")

    def node(self, i: int, indent: int, parent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if self._is_seq(i):
            return self.sequence(i, indent)
        if _key_split(line.text, self.where(i)) is not None:
            return self.mapping(i, indent)
        return self.value(i, line.text, parent)

    def value(self, i: int, text: str, parent: int) -> Tuple[Any, int]:
        """The scalar or flow value `text` (a suffix of line i's text) and
        the next line; plain and quoted scalars may go on over lines
        indented more than `parent`."""
        line, where = self.lines[i], self.where(i)
        t = text.strip()
        if t[:1] in ("'", '"'):
            try:
                return _scalar_or_flow(t, where), i + 1
            except _Unterminated:
                pass
            start = len(line.text) - len(text.lstrip())  # where the quote is, in line.raw
            s = "\n".join([line.raw] + self.raw[line.no:])
            value, end = _quoted(s, start, where)
            last_no = line.no + s.count("\n", 0, end)
            if _strip_comment(s[end:].split("\n", 1)[0]).strip():
                raise YAMLSyntaxError(f"{self.fname}:{last_no}: text after a quoted string")
            while i < len(self.lines) and self.lines[i].no <= last_no:
                i += 1
            return value, i
        if t[:1] in ("[", "{"):
            value = _scalar_or_flow(t, where)
            if i + 1 < len(self.lines) and self.lines[i + 1].indent > parent:
                raise YAMLSyntaxError(f"{self.where(i + 1)}: multi-line flow collections are not supported")
            return value, i + 1
        parts = [t]
        j = i
        while j + 1 < len(self.lines) and self.lines[j + 1].indent > parent:
            if self.lines[j].text != self.lines[j].raw.rstrip():
                raise YAMLSyntaxError(f"{self.where(j + 1)}: a plain scalar goes on after a comment")
            gap = self.raw[self.lines[j].no:self.lines[j + 1].no - 1]
            if any(g.strip() for g in gap):
                raise YAMLSyntaxError(f"{self.where(j + 1)}: a plain scalar goes on after a comment")
            parts.append("\n" * len(gap) if gap else " ")
            parts.append(self.lines[j + 1].text.strip())
            j += 1
        return _plain("".join(parts), where, flow=False), j + 1

    def _inline(self, i: int, col: int, text: str):
        """Make lines[i] the compact node `text` starting at column `col`."""
        line = self.lines[i]
        self.lines[i] = _Line(col, text, line.no, self.raw[line.no - 1][col:])

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i].indent == indent and self._is_seq(i):
            line = self.lines[i]
            rest = line.text[1:]
            if rest.strip():
                col = indent + 1 + (len(rest) - len(rest.lstrip(" ")))
                self._inline(i, col, rest.lstrip(" "))
                value, i = self.node(i, col, indent)
            elif i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
                value, i = self.node(i + 1, self.lines[i + 1].indent, indent)
            else:
                value, i = None, i + 1
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YAMLSyntaxError(f"{self.where(i)}: bad indentation of a sequence entry")
        return out, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i].indent == indent and not self._is_seq(i):
            where = self.where(i)
            split = _key_split(self.lines[i].text, where)
            if split is None:
                raise YAMLSyntaxError(f"{where}: expected 'key: value', got {self.lines[i].text!r}")
            key, rest = split
            if rest.strip():
                value, i = self.value(i, rest, indent)
            elif i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
                value, i = self.node(i + 1, self.lines[i + 1].indent, indent)
            elif i + 1 < len(self.lines) and self.lines[i + 1].indent == indent and self._is_seq(i + 1):
                value, i = self.sequence(i + 1, indent)  # a sequence unindented under its key
            else:
                value, i = None, i + 1
            _set(out, key, value, where)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YAMLSyntaxError(f"{self.where(i)}: bad indentation of a mapping entry")
        return out, i


def loads(text: str, fname: str = "<string>") -> Any:
    """The value of the YAML document `text`, as `yaml.safe_load` reads it."""
    return _Parser(text, fname).parse()


def load(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read(), path)


# ---------------------------------------------------------------- writing


def _float_repr(x: float) -> str:
    """PyYAML's `represent_float`."""
    if x != x:
        return ".nan"
    if x == math.inf:
        return ".inf"
    if x == -math.inf:
        return "-.inf"
    v = repr(x).lower()
    if "." not in v and "e" in v:
        v = v.replace("e", ".0e", 1)
    return v


_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./+~$()=<>^][A-Za-z0-9_./+~$()=<>^ -]*$")


def _str_repr(s: str) -> str:
    if _PLAIN_SAFE.match(s) and not s.endswith(" ") and not s.startswith("~"):
        try:
            if resolve_plain(s) == s:
                return s
        except YAMLSyntaxError:
            pass
    if all(" " <= c <= "~" for c in s):
        return "'" + s.replace("'", "''") + "'"
    out = []
    for c in s:
        if c == '"':
            out.append('\\"')
        elif c == "\\":
            out.append("\\\\")
        elif " " <= c <= "~" or (ord(c) > 0xa0 and c.isprintable()):
            out.append(c)
        else:
            code = ord(c)
            out.append(f"\\x{code:02X}" if code <= 0xff else f"\\u{code:04X}" if code <= 0xffff
                       else f"\\U{code:08X}")
    return '"' + "".join(out) + '"'


def _scalar_repr(x) -> str:
    if hasattr(x, "item") and not isinstance(x, (str, bytes, list, dict)):  # numpy scalars
        x = x.item()
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        return _float_repr(x)
    if isinstance(x, str):
        return _str_repr(x)
    raise TypeError(f"cannot write a {type(x).__name__} to a config file")


def _emit(value, indent: int, out: List[str]):
    pad = " " * indent
    if isinstance(value, dict):
        for k in sorted(value):
            v = value[k]
            head = f"{pad}{_scalar_repr(k)}:"
            if isinstance(v, dict) and v:
                out.append(head)
                _emit(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(head)
                _emit(list(v), indent, out)
            else:
                out.append(f"{head} {_value_repr(v)}")
    else:
        for v in value:
            if isinstance(v, (dict, list, tuple)) and v:
                sub: List[str] = []
                _emit(list(v) if isinstance(v, tuple) else v, indent + 2, sub)
                out.append(pad + "- " + sub[0][indent + 2:])
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_value_repr(v)}")


def _value_repr(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar_repr(v)


def dumps(mapping) -> str:
    """A mapping as YAML text, in `yaml.safe_dump(..., sort_keys=True)`'s
    layout."""
    if not isinstance(mapping, dict):
        raise TypeError("only a mapping is written")
    if not mapping:
        return "{}\n"
    out: List[str] = []
    _emit(mapping, 0, out)
    return "\n".join(out) + "\n"
