"""A reader of the YAML that OSS-Fuzz's ``project.yaml`` files use, without
PyYAML (the card's machine has none).

:func:`load` returns what ``yaml.safe_load`` returns for a document of
the subset: block mappings and sequences (a sequence of mappings too, and
a sequence at its key's indentation), flow sequences and mappings,
single- and double-quoted scalars, multi-line plain scalars, comments,
and ``|`` and ``>`` block scalars with their chomping and indentation
indicators.  Plain scalars resolve as PyYAML's SafeLoader resolves them
(YAML 1.1): ``~``, ``null`` and empty are None; ``yes``/``no``/``on``/
``off``/``true``/``false`` in their three cases are bools; ints take a
sign, ``_`` separators, ``0x``, ``0b``, a leading-``0`` octal and base 60
(``1:30``); floats need a dot (``1.5``, ``1.0e+3``, ``.inf``, ``.nan``);
``2020-01-02`` is a ``datetime.date`` and ``2020-01-02 03:04:05`` a
``datetime.datetime``.  Keys resolve too.

Two kinds of input are refused, differently:

- malformed input (bad indentation, an unclosed quote or bracket, a tab
  in the indentation, a mapping value where none may stand) raises
  :class:`MalformedYaml`, which the project collector treats as PyYAML's
  ``YAMLError``: it warns and skips the project;
- a valid construct outside the subset (anchors, aliases, tags, ``---``
  and ``...`` markers, directives, ``?`` keys, merge keys) raises
  :class:`OutsideSubset`, naming the file and the line: the run stops,
  since skipping it would differ from the JAX package without a word.
"""

from __future__ import annotations

import datetime
import re


class MalformedYaml(ValueError):
    """Input PyYAML would also refuse."""


class OutsideSubset(ValueError):
    """Valid YAML that this reader does not implement."""


# -- scalar resolution (PyYAML's yaml/resolver.py and constructor.py) ----

_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = ("~", "null", "Null", "NULL", "")
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TS_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TS_PARTS = re.compile(
    r"^([0-9][0-9][0-9][0-9])-([0-9][0-9]?)-([0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)([0-9][0-9]?):([0-9][0-9]):([0-9][0-9])"
    r"(?:\.([0-9]*))?(?:[ \t]*(Z|([-+])([0-9][0-9]?)"
    r"(?::([0-9][0-9]))?))?)?$")


def _sexagesimal(text: str, cast) -> int | float:
    digits = [cast(part) for part in text.split(":")]
    digits.reverse()
    base, value = 1, 0
    for d in digits:
        value += d * base
        base *= 60
    return value


def _int(text: str) -> int:
    v = text.replace("_", "")
    sign = 1
    if v[0] == "-":
        sign = -1
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


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = 1.0
    if v[0] == "-":
        sign = -1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _timestamp(text: str):
    m = _TS_PARTS.match(text)
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    if m.group(4) is None:
        return datetime.date(y, mo, d)
    hh, mm, ss = int(m.group(4)), int(m.group(5)), int(m.group(6))
    frac = m.group(7) or ""
    micro = int(frac[:6].ljust(6, "0")) if frac else 0
    tz = None
    if m.group(8):
        if m.group(8) == "Z":
            tz = datetime.timezone.utc
        else:
            delta = datetime.timedelta(hours=int(m.group(10)),
                                       minutes=int(m.group(11) or 0))
            if m.group(9) == "-":
                delta = -delta
            tz = datetime.timezone(delta)
    return datetime.datetime(y, mo, d, hh, mm, ss, micro, tzinfo=tz)


def resolve(text: str):
    """A plain scalar as SafeLoader constructs it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text[0] in "-+0123456789" and _INT_RE.match(text):
        return _int(text)
    if text[0] in "-+0123456789." and _FLOAT_RE.match(text):
        return _float(text)
    if text[0] in "0123456789" and _TS_RE.match(text):
        return _timestamp(text)
    return text


# -- the parser ----------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Parser:
    def __init__(self, text: str, name: str):
        self.name = name
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        if text.startswith("﻿"):
            text = text[1:]
        self.lines = text.split("\n")
        if self.lines[-1] == "":
            self.lines.pop()    # the final line break ends no line
        self.i = 0

    # -- errors --

    def bad(self, msg: str, line: int | None = None):
        line = self.i if line is None else line
        return MalformedYaml(f"{self.name}:{line + 1}: {msg}")

    def outside(self, what: str, line: int | None = None):
        line = self.i if line is None else line
        return OutsideSubset(
            f"{self.name}:{line + 1}: {what} is valid YAML outside the "
            "subset this reader implements (collect/yaml_subset.py)")

    # -- lines --

    @staticmethod
    def _indent(line: str) -> int:
        return len(line) - len(line.lstrip(" "))

    def _blank(self, line: str) -> bool:
        s = line.strip(" \t")
        return not s or s.startswith("#")

    def _skip_blank(self) -> None:
        while self.i < len(self.lines) and self._blank(self.lines[self.i]):
            self.i += 1

    def _check_line(self, k: int) -> None:
        line = self.lines[k]
        lead = line[:len(line) - len(line.lstrip(" \t"))]
        if "\t" in lead and line.strip():
            raise self.bad("found a tab character in the indentation", k)
        if line.startswith("%"):
            raise self.outside("a directive", k)
        if line.rstrip() in ("---", "...") or line.startswith(("--- ",
                                                               "... ")):
            raise self.outside("a document marker", k)

    # -- document --

    def document(self):
        for k in range(len(self.lines)):
            self._check_line(k)
        self._skip_blank()
        if self.i >= len(self.lines):
            return None
        indent = self._indent(self.lines[self.i])
        node = self.block(indent)
        self._skip_blank()
        if self.i < len(self.lines):
            raise self.bad("expected the end of the document (bad "
                           "indentation?)")
        return node

    def block(self, indent: int):
        """The node starting at line ``self.i``, indented ``indent``."""
        content = self.lines[self.i][indent:]
        if content == "-" or content.startswith(("- ", "-\t")):
            return self.sequence(indent)
        if self._split_key(content, self.i) is not None:
            return self.mapping(indent)
        return self.value(content, indent - 1, self.i)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            self._skip_blank()
            if self.i >= len(self.lines):
                break
            line = self.lines[self.i]
            ind = self._indent(line)
            if ind < indent:
                break
            content = line[indent:]
            is_entry = content == "-" or content.startswith(("- ", "-\t"))
            if ind == indent and not is_entry:
                break       # the enclosing mapping's next key
            if ind > indent:
                raise self.bad("expected a sequence entry ('- ') at this "
                               "indentation")
            rest = content[1:]
            if self._blank(rest):
                self.i += 1
                self._skip_blank()
                if self.i < len(self.lines) and \
                        self._indent(self.lines[self.i]) > indent:
                    out.append(self.block(self._indent(self.lines[self.i])))
                else:
                    out.append(None)
                continue
            # Compact form: re-read the entry's content as a node at its
            # own column ("- a: 1" is a mapping at indent + 2).
            col = indent + 1 + (len(rest) - len(rest.lstrip(" ")))
            self.lines[self.i] = " " * col + rest.lstrip(" ")
            out.append(self.block(col))
        return out

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            self._skip_blank()
            if self.i >= len(self.lines):
                break
            line = self.lines[self.i]
            ind = self._indent(line)
            if ind < indent:
                break
            if ind > indent:
                raise self.bad("bad indentation of a mapping entry")
            content = line[indent:]
            if content == "-" or content.startswith(("- ", "-\t")):
                raise self.bad("expected a mapping key, found a sequence "
                               "entry")
            split = self._split_key(content, self.i)
            if split is None:
                raise self.bad("expected a mapping key ('key: value')")
            key, rest = split
            if key == "<<":
                raise self.outside("a merge key ('<<')")
            here = self.i
            if self._blank(rest):
                self.i += 1
                self._skip_blank()
                value = None
                if self.i < len(self.lines):
                    nxt = self.lines[self.i]
                    nind = self._indent(nxt)
                    ncontent = nxt[nind:]
                    if nind > indent:
                        value = self.block(nind)
                    elif nind == indent and (
                            ncontent == "-" or
                            ncontent.startswith(("- ", "-\t"))):
                        value = self.sequence(indent)
            else:
                value = self.value(rest, indent, here)
            if isinstance(key, (list, dict)):
                raise self.outside("a collection as a key", here)
            out[key] = value
        return out

    def _split_key(self, content: str, k: int):
        """``(key, rest)`` when ``content`` is a block mapping entry,
        else None."""
        if content.startswith("? ") or content == "?":
            raise self.outside("a complex key ('? ')", k)
        if content[:1] in ("'", '"'):
            text, end = self._quoted(content, 0, k)
            if end < 0:
                return None
            after = content[end:]
            stripped = after.lstrip(" ")
            if stripped.startswith(":") and (len(stripped) == 1 or
                                             stripped[1] in " \t"):
                return text, stripped[1:]
            return None
        if content[:1] in ("[", "{", "#", "&", "*", "!", "|", ">", "%",
                           "@", "`", ",", "]", "}"):
            return None
        j = 0
        while True:
            j = content.find(":", j)
            if j < 0:
                return None
            if " #" in content[:j] or "\t#" in content[:j]:
                return None
            if j + 1 == len(content) or content[j + 1] in " \t":
                key = content[:j].rstrip(" \t")
                return resolve(key), content[j + 1:]
            j += 1

    def value(self, rest: str, parent: int, k: int):
        """The value that starts with ``rest`` on line ``k`` (its
        key's indentation is ``parent``); consumes its lines."""
        s = rest.strip(" \t")
        head = s[:1]
        if head in ("&", "*", "!"):
            raise self.outside({"&": "an anchor", "*": "an alias",
                                "!": "a tag"}[head], k)
        if head in ("|", ">"):
            return self._block_scalar(s, parent, k)
        if head in ("[", "{"):
            return self._flow(rest, k)
        if head in ("'", '"'):
            col = len(self.lines[k]) - len(rest) + (len(rest) - len(
                rest.lstrip(" \t")))
            text, end_line, end_col = self._quoted_multiline(k, col)
            tail = self.lines[end_line][end_col:]
            if not self._blank(tail):
                if tail.lstrip(" ").startswith(":"):
                    raise self.bad("a mapping value is not allowed here",
                                   end_line)
                raise self.bad("unexpected text after a quoted scalar",
                               end_line)
            self.i = end_line + 1
            self._no_deeper(parent)
            return text
        if head in ("%", "@", "`", ",", "]", "}", "#"):
            if head == "#":
                self.i = k + 1
                return None
            raise self.bad(f"a plain scalar cannot start with {head!r}", k)
        if head == "?" and (len(s) == 1 or s[1] in " \t"):
            raise self.outside("a complex key ('? ')", k)
        if head == "-" and (len(s) == 1 or s[1] in " \t"):
            raise self.bad("a sequence entry is not allowed here", k)
        return self._plain(s, parent, k)

    def _no_deeper(self, parent: int) -> None:
        self._skip_blank()
        if self.i < len(self.lines) and \
                self._indent(self.lines[self.i]) > parent and parent >= 0:
            raise self.bad("bad indentation after a complete value")

    @staticmethod
    def _strip_comment(s: str) -> str:
        for sep in (" #", "\t#"):
            j = s.find(sep)
            if j >= 0:
                s = s[:j]
        return s.rstrip(" \t")

    def _plain(self, s: str, parent: int, k: int):
        first = self._strip_comment(s)
        if ": " in first or first.endswith(":"):
            raise self.bad("a mapping value is not allowed here", k)
        parts = [first]
        commented = first != s.rstrip(" \t")
        self.i = k + 1
        # Continuation lines: indented deeper than the key, until a
        # comment ends the scalar.
        breaks = 0
        while self.i < len(self.lines) and not commented:
            line = self.lines[self.i]
            if not line.strip(" \t"):
                breaks += 1
                self.i += 1
                continue
            ind = self._indent(line)
            body = line.strip(" \t")
            if ind <= parent or body.startswith("#"):
                break
            text = self._strip_comment(body)
            commented = text != body
            if ": " in text or text.endswith(":"):
                raise self.bad("a mapping value is not allowed here",
                               self.i)
            parts.append("\n" * breaks if breaks else " ")
            parts.append(text)
            breaks = 0
            self.i += 1
        text = "".join(parts)
        return resolve(text) if len(parts) == 1 else text

    def _block_scalar(self, s: str, parent: int, k: int) -> str:
        header = self._strip_comment(s)
        m = re.fullmatch(r"([|>])([+-]?)([1-9]?)([+-]?)", header)
        if m is None:
            raise self.bad("bad block scalar header", k)
        style = m.group(1)
        chomp = m.group(2) or m.group(4)
        explicit = int(m.group(3)) if m.group(3) else None
        base = max(parent, 0) if parent >= 0 else 0
        i = k + 1
        lines: list[str] = []
        indent = base + explicit if explicit else None
        if indent is None:
            j = i
            while j < len(self.lines) and not self.lines[j].strip(" "):
                j += 1
            if j < len(self.lines):
                indent = self._indent(self.lines[j])
            if indent is None or indent <= parent:
                indent = parent + 1 if parent >= 0 else 1
        while i < len(self.lines):
            line = self.lines[i]
            if line.strip(" ") == "":
                lines.append(line[indent:] if len(line) > indent else "")
                i += 1
                continue
            if self._indent(line) < indent:
                break
            lines.append(line[indent:])
            i += 1
        self.i = i
        # Trailing empty lines are chomped below.
        n_trail = 0
        while lines and lines[-1] == "":
            lines.pop()
            n_trail += 1
        if style == "|":
            body = "\n".join(lines)
        else:
            body = self._fold(lines)
        if not lines:
            return "\n" * n_trail if chomp == "+" else ""
        if chomp == "-":
            return body
        if chomp == "+":
            return body + "\n" + "\n" * n_trail
        return body + "\n"

    @staticmethod
    def _fold(lines: list[str]) -> str:
        out = ""
        prev_more = True
        pending_breaks = 0
        for n, line in enumerate(lines):
            more = line[:1] in (" ", "\t")
            if line == "":
                pending_breaks += 1
                continue
            if n == 0 or (not out and pending_breaks == 0):
                out += "\n" * pending_breaks + line
            elif more or prev_more:
                out += "\n" + "\n" * pending_breaks + line
            elif pending_breaks:
                out += "\n" * pending_breaks + line
            else:
                out += " " + line
            pending_breaks = 0
            prev_more = more
        return out

    # -- quoted scalars --

    def _quoted(self, text: str, start: int, k: int) -> tuple[str, int]:
        """A quoted scalar starting at ``text[start]``: (value, index
        after the closing quote), the index -1 when the line holds no
        closing quote."""
        q = text[start]
        out = []
        j = start + 1
        while j < len(text):
            c = text[j]
            if q == "'":
                if c == "'":
                    if j + 1 < len(text) and text[j + 1] == "'":
                        out.append("'")
                        j += 2
                        continue
                    return "".join(out), j + 1
                out.append(c)
                j += 1
                continue
            if c == '"':
                return "".join(out), j + 1
            if c == "\\":
                j, piece = self._escape(text, j, k)
                out.append(piece)
                continue
            out.append(c)
            j += 1
        return "".join(out), -1

    def _escape(self, text: str, j: int, k: int) -> tuple[int, str]:
        if j + 1 >= len(text):
            return j + 1, ""
        c = text[j + 1]
        if c in _ESCAPES:
            return j + 2, _ESCAPES[c]
        if c in _HEX:
            n = _HEX[c]
            digits = text[j + 2:j + 2 + n]
            if len(digits) < n or not re.fullmatch(r"[0-9A-Fa-f]+",
                                                   digits):
                raise self.bad("bad escape in a double-quoted scalar", k)
            return j + 2 + n, chr(int(digits, 16))
        raise self.bad(f"unknown escape '\\{c}' in a double-quoted scalar",
                       k)

    def _quoted_multiline(self, k: int, col: int):
        """A quoted scalar starting at line ``k``, column ``col``, maybe
        folded over several lines: (value, end line, end column)."""
        line = self.lines[k]
        q = line[col]
        text, end = self._quoted(line, col, k)
        if end >= 0:
            return text, k, end
        # Folded: each line break is a space, an empty line a newline.
        pieces = [self._unquote(line[col + 1:].rstrip(" \t"), q, k)]
        i = k + 1
        breaks = 0
        while i < len(self.lines):
            cur = self.lines[i]
            body = cur.strip(" \t")
            if cur.startswith(("---", "...")) and \
                    cur.rstrip() in ("---", "..."):
                break
            end_at = self._find_close(cur, q)
            if body == "":
                breaks += 1
                i += 1
                continue
            lead = len(cur) - len(cur.lstrip(" \t"))
            if end_at >= 0:
                seg = cur[lead:end_at]
                sep = "\n" * breaks if breaks else (
                    "" if pieces[-1].endswith("\\\n") else " ")
                pieces.append(sep + self._unquote(seg, q, i))
                value = "".join(pieces).replace("\\\n", "")
                return value, i, end_at + 1
            seg = cur[lead:].rstrip(" \t")
            sep = "\n" * breaks if breaks else " "
            pieces.append(sep + self._unquote(seg, q, i))
            breaks = 0
            i += 1
        raise self.bad("unclosed quoted scalar", k)

    def _find_close(self, s: str, q: str) -> int:
        j = 0
        while j < len(s):
            c = s[j]
            if q == "'" and c == "'":
                if j + 1 < len(s) and s[j + 1] == "'":
                    j += 2
                    continue
                return j
            if q == '"':
                if c == "\\":
                    j += 2
                    continue
                if c == '"':
                    return j
            j += 1
        return -1

    def _unquote(self, seg: str, q: str, k: int) -> str:
        if q == "'":
            return seg.replace("''", "'")
        out = []
        j = 0
        while j < len(seg):
            c = seg[j]
            if c == "\\":
                if j + 1 == len(seg):
                    out.append("\\\n")  # an escaped line break
                    j += 1
                    continue
                j, piece = self._escape(seg, j, k)
                out.append(piece)
                continue
            out.append(c)
            j += 1
        return "".join(out)

    # -- flow collections --

    def _flow(self, rest: str, k: int):
        col = len(self.lines[k]) - len(rest.lstrip(" \t"))
        text = self.lines[k][col:]
        i = k
        buf = text
        while True:
            try:
                node, end = _FlowReader(buf, self, k).read()
                break
            except _NeedMore:
                i += 1
                if i >= len(self.lines):
                    raise self.bad("unclosed flow collection", k)
                buf += "\n" + self.lines[i]
        tail = buf[end:]
        if not self._blank(tail.split("\n")[-1] if "\n" in tail else tail):
            raise self.bad("unexpected text after a flow collection", i)
        self.i = i + 1
        return node


class _NeedMore(Exception):
    pass


class _FlowReader:
    def __init__(self, text: str, parser: _Parser, k: int):
        self.s = text
        self.p = parser
        self.k = k
        self.j = 0

    def _ws(self) -> None:
        while self.j < len(self.s):
            c = self.s[self.j]
            if c in " \t\n":
                self.j += 1
            elif c == "#" and (self.j == 0 or self.s[self.j - 1] in " \t\n"):
                nl = self.s.find("\n", self.j)
                if nl < 0:
                    raise _NeedMore()
                self.j = nl
            else:
                break
        if self.j >= len(self.s):
            raise _NeedMore()

    def read(self):
        node = self.node()
        return node, self.j

    def node(self):
        self._ws()
        c = self.s[self.j]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in ("&", "*", "!"):
            raise self.p.outside({"&": "an anchor", "*": "an alias",
                                  "!": "a tag"}[c], self.k)
        if c in ("'", '"'):
            return self.quoted()
        if c == "?" and self.s[self.j + 1:self.j + 2] in (" ", "\n"):
            raise self.p.outside("a complex key ('? ')", self.k)
        return self.plain()

    def quoted(self):
        q = self.s[self.j]
        end = self.p._find_close(self.s[self.j + 1:], q)
        if end < 0:
            raise _NeedMore()
        raw = self.s[self.j + 1:self.j + 1 + end]
        self.j += end + 2
        lines = raw.split("\n")
        if len(lines) == 1:
            return self.p._unquote(raw, q, self.k)
        out = [self.p._unquote(lines[0].rstrip(" \t"), q, self.k)]
        breaks = 0
        for ln in lines[1:]:
            b = ln.strip(" \t")
            if not b:
                breaks += 1
                continue
            out.append(("\n" * breaks if breaks else " ")
                       + self.p._unquote(b, q, self.k))
            breaks = 0
        return "".join(out).replace("\\\n ", "").replace("\\\n", "")

    def plain(self):
        start = self.j
        while self.j < len(self.s):
            c = self.s[self.j]
            if c in ",[]{}":
                break
            if c == ":" and (self.j + 1 == len(self.s) or
                             self.s[self.j + 1] in " \t\n,[]{}"):
                break
            if c == "#" and self.s[self.j - 1] in " \t\n":
                break
            self.j += 1
        if self.j >= len(self.s):
            raise _NeedMore()
        text = " ".join(w for w in re.split(r"\s*\n\s*",
                                            self.s[start:self.j].strip()))
        if not text:
            raise self.p.bad("an empty entry in a flow collection", self.k)
        return resolve(text)

    def seq(self) -> list:
        self.j += 1
        out = []
        while True:
            self._ws()
            if self.s[self.j] == "]":
                self.j += 1
                return out
            item = self.node()
            self._ws()
            if self.s[self.j] == ":":
                raise self.p.outside("a single-pair mapping inside a flow "
                                     "sequence", self.k)
            out.append(item)
            self._ws()
            c = self.s[self.j]
            if c == ",":
                self.j += 1
            elif c != "]":
                raise self.p.bad("expected ',' or ']' in a flow sequence",
                                 self.k)

    def map(self) -> dict:
        self.j += 1
        out: dict = {}
        while True:
            self._ws()
            if self.s[self.j] == "}":
                self.j += 1
                return out
            key = self.node()
            if isinstance(key, (list, dict)):
                raise self.p.outside("a collection as a key", self.k)
            self._ws()
            value = None
            if self.s[self.j] == ":":
                self.j += 1
                self._ws()
                if self.s[self.j] not in ",}":
                    value = self.node()
            out[key] = value
            self._ws()
            c = self.s[self.j]
            if c == ",":
                self.j += 1
            elif c != "}":
                raise self.p.bad("expected ',' or '}' in a flow mapping",
                                 self.k)


def load(text: str, name: str = "<yaml>"):
    """``yaml.safe_load(text)`` for a document of the subset."""
    return _Parser(text, name).document()


def load_file(path: str):
    with open(path, encoding="utf-8") as f:
        return load(f.read(), path)


__all__ = ["MalformedYaml", "OutsideSubset", "load", "load_file",
           "resolve"]
