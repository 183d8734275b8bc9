"""A YAML writer without PyYAML: the text of
``yaml.safe_dump(value, default_flow_style=None, sort_keys=False)``.

The JAX runner writes every ``data``, ``cfg`` and ``meta`` part with that
call (consensus_specs_tpu/gen/gen_runner.py); the card's machine has no
PyYAML, so the port writes the same text itself. Its input is what
``gen_runner._plainify`` returns: dicts with string keys, lists, strings,
ints (of any size) and bools. No container may appear twice (PyYAML would
write an anchor and an alias); ``_plainify`` builds fresh ones. Strings
are printable ASCII and keys are short and non-empty, as every part a
generator writes is (hex, names, numbers): anything else raises, so the
writer never needs PyYAML's double-quoted style, its complex ``?`` keys
or its line-broken scalars.

The contract, PyYAML's (YAML 1.1, width 80, indent 2, ASCII):

- a list or dict whose items are all scalars goes in flow style
  (``[1, 2]``, ``{a: 1}``); one with a nested container goes in block
  style, a list under a key at the key's own indent; empty ones are
  ``[]`` and ``{}``;
- a flow item that would start past column 80 starts a new line at the
  flow indent (two spaces deeper than its block), and a long plain or
  single-quoted string breaks at a space past column 80;
- a string that YAML 1.1 would read as another type (``'0x..'`` and
  ``'12'`` as ints, ``'true'``, ``'null'``, ``''``, ...) is single-quoted,
  as is one with indicator characters (``: ``, `` #``, a leading ``-``
  ...) or a leading or trailing space;
- booleans are ``true``/``false``; a scalar document written plain ends
  with ``...``.

The writer follows PyYAML's emitter state by state (column, indent stack,
whitespace and indention flags), so its line breaks fall where PyYAML's do.
"""
import re

BEST_WIDTH = 80
BEST_INDENT = 2

_STR, _INT, _BOOL = "str", "int", "bool"
# the longest key PyYAML writes as a simple key (with its 5-character tag
# "!!str", under 128)
_MAX_KEY = 122

# YAML 1.1 implicit types, by first character (PyYAML's resolver table)
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*
                    (?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_MERGE_RE = re.compile(r"^(?:<<)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                           re.X)
_VALUE_RE = re.compile(r"^(?:=)$")
_YAML_RE = re.compile(r"^(?:!|&|\*)$")

_RESOLVERS = {}
for _regexp, _first in ((_BOOL_RE, "yYnNtTfFoO"), (_FLOAT_RE, "-+0123456789."),
                        (_INT_RE, "-+0123456789"), (_MERGE_RE, "<"),
                        (_NULL_RE, ["~", "n", "N", ""]),
                        (_TIMESTAMP_RE, "0123456789"), (_VALUE_RE, "="),
                        (_YAML_RE, "!&*")):
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append(_regexp)

def _plain_is_str(text: str) -> bool:
    """True when YAML 1.1 reads ``text``, unquoted, as a string."""
    return not any(r.match(text) for r in _RESOLVERS.get(text[:1], ()))


class _Scalar:
    __slots__ = ("tag", "text", "implicit", "flow_plain", "block_plain")

    def __init__(self, tag, text):
        self.tag, self.text = tag, text
        # plain style keeps the type only where the text resolves to it
        self.implicit = _plain_is_str(text) if tag == _STR else True
        self._analyze(text)

    def _analyze(self, s):
        """PyYAML's analyze_scalar on printable ASCII: may the text go
        plain in flow and in block context?"""
        if not s:  # resolves to null: always quoted
            self.flow_plain = self.block_plain = False
            return
        block_ind = flow_ind = s.startswith(("---", "..."))
        preceded_ws = True
        followed_ws = len(s) == 1 or s[1] == " "
        for i, ch in enumerate(s):
            if i == 0:
                if ch in "#,[]{}&*!|>'\"%@`":
                    flow_ind = block_ind = True
                if ch in "?:":
                    flow_ind = True
                    if followed_ws:
                        block_ind = True
                if ch == "-" and followed_ws:
                    flow_ind = block_ind = True
            else:
                if ch in ",?[]{}":
                    flow_ind = True
                if ch == ":":
                    flow_ind = True
                    if followed_ws:
                        block_ind = True
                if ch == "#" and preceded_ws:
                    flow_ind = block_ind = True
            preceded_ws = ch == " "
            followed_ws = i + 2 >= len(s) or s[i + 2] == " "
        edge_space = s[0] == " " or s[-1] == " "
        self.flow_plain = not (edge_space or flow_ind)
        self.block_plain = not (edge_space or block_ind)


def _check_text(text, what):
    if not all(" " <= ch <= "~" for ch in text):
        raise ValueError(f"yaml_writer: {what} {text!r} is not printable "
                         "ASCII")


def _represent(value):
    """(node, is_scalar): PyYAML's representer on plain data. A
    collection is ("seq", items, flow) or ("map", pairs, flow), flow when
    every item (every key and value) is a scalar."""
    if isinstance(value, bool):
        return _Scalar(_BOOL, "true" if value else "false"), True
    if isinstance(value, int):
        return _Scalar(_INT, str(int(value))), True
    if isinstance(value, str):
        _check_text(value, "string")
        return _Scalar(_STR, value), True
    if isinstance(value, (list, tuple)):
        items = [_represent(v) for v in value]
        return ("seq", [n for n, _ in items],
                all(s for _, s in items)), False
    if isinstance(value, dict):
        pairs = []
        flow = True
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError(f"yaml_writer: key {k!r} is not a string")
            if not 0 < len(k) <= _MAX_KEY:
                raise ValueError(f"yaml_writer: key {k!r} is not simple")
            kn, _ = _represent(k)
            vn, vs = _represent(v)
            flow = flow and vs
            pairs.append((kn, vn))
        return ("map", pairs, flow), False
    raise TypeError(f"yaml_writer: cannot write {type(value).__name__}")


class _Emitter:
    def __init__(self):
        self.out = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.open_ended = False
        self.indent = None
        self.indents = []
        self.flow_level = 0
        self.root = self.mapping_ctx = self.simple_key = False

    # -- low-level writers ---------------------------------------------------

    def _write(self, data):
        self.column += len(data)
        self.out.append(data)

    def indicator(self, text, need_ws, whitespace=False, indention=False):
        data = text if self.whitespace or not need_ws else " " + text
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False
        self._write(data)

    def line_break(self):
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append("\n")

    def write_indent(self):
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self._write(" " * (indent - self.column))

    def increase_indent(self, flow=False, indentless=False):
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = BEST_INDENT if flow else 0
        elif not indentless:
            self.indent += BEST_INDENT

    # -- nodes ---------------------------------------------------------------

    def node(self, n, root=False, mapping=False, simple_key=False):
        self.root, self.mapping_ctx = root, mapping
        self.simple_key = simple_key
        if isinstance(n, _Scalar):
            self.scalar(n)
        elif n[0] == "seq":
            if self.flow_level or n[2] or not n[1]:
                self.flow_seq(n[1])
            else:
                self.block_seq(n[1])
        elif self.flow_level or n[2] or not n[1]:
            self.flow_map(n[1])
        else:
            self.block_map(n[1])

    def flow_seq(self, items):
        self.indicator("[", True, whitespace=True)
        self.flow_level += 1
        self.increase_indent(flow=True)
        for i, item in enumerate(items):
            if i:
                self.indicator(",", False)
            if self.column > BEST_WIDTH:
                self.write_indent()
            self.node(item)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.indicator("]", False)

    def flow_map(self, pairs):
        self.indicator("{", True, whitespace=True)
        self.flow_level += 1
        self.increase_indent(flow=True)
        for i, (k, v) in enumerate(pairs):
            if i:
                self.indicator(",", False)
            if self.column > BEST_WIDTH:
                self.write_indent()
            self.node(k, mapping=True, simple_key=True)
            self.indicator(":", False)
            self.node(v, mapping=True)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.indicator("}", False)

    def block_seq(self, items):
        # a list under a key sits at the key's indent
        self.increase_indent(indentless=self.mapping_ctx
                             and not self.indention)
        for item in items:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def block_map(self, pairs):
        self.increase_indent()
        for k, v in pairs:
            self.write_indent()
            self.node(k, mapping=True, simple_key=True)
            self.indicator(":", False)
            self.node(v, mapping=True)
        self.indent = self.indents.pop()

    # -- scalars -------------------------------------------------------------

    def scalar(self, s):
        self.increase_indent(flow=True)
        split = not self.simple_key
        if s.implicit and (s.flow_plain if self.flow_level else s.block_plain):
            self.plain(s.text, split)
        else:
            self.single_quoted(s.text, split)
        self.indent = self.indents.pop()

    def plain(self, text, split):
        if self.root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self._write(" ")
        self.whitespace = self.indention = False
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > BEST_WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self._write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self._write(text[start:end])
                start = end
            spaces = ch == " "
            end += 1

    def single_quoted(self, text, split):
        self.indicator("'", True)
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > BEST_WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self._write(text[start:end])
                    start = end
            elif ch is None or ch in " '":
                if start < end:
                    self._write(text[start:end])
                    start = end
            if ch == "'":
                self._write("''")
                start = end + 1
            spaces = ch == " "
            end += 1
        self.indicator("'", False)

    # -- the document --------------------------------------------------------

    def document(self, root):
        self.node(root, root=True)
        self.write_indent()
        if self.open_ended:
            self.indicator("...", True)
            self.write_indent()
        return "".join(self.out)


def dump(value) -> str:
    """The text ``yaml.safe_dump(value, default_flow_style=None,
    sort_keys=False)`` returns."""
    node, _ = _represent(value)
    return _Emitter().document(node)
