"""GraphML files of networkx graphs, byte-equal to `nx.write_graphml`'s.

`write_graphml(G, path)` writes the bytes that `nx.write_graphml(G, path)`
writes on the same host, in one walk over the graph and one write.
networkx builds one XML element per node, edge and attribute value and
then serializes the tree; this module builds the text itself: each
attribute's `<data key=...>` prefix is made once per (name, type), and a
node's escaped id once per node and reused on its edges.

networkx binds `nx.write_graphml` to `write_graphml_lxml`, which takes
lxml where `lxml.etree` imports and falls back to `write_graphml_xml`
(ElementTree, indented) where it does not
(networkx/readwrite/graphml.py:164-175, :836).  The two write the same
graph in other bytes: other indentation, empty elements and escapes.  So
the layout follows what `nx.write_graphml` is bound to at the call:

- `write_graphml_xml`: ElementTree's layout;
- `write_graphml_lxml`: lxml's layout where `lxml.etree` imports, else
  ElementTree's;
- anything else (a caller's own binding): the file goes to
  `nx.write_graphml`.

What both networkx writers share, this one keeps: `G.graph` ("id" popped
into the graph element, "node_default"/"edge_default" giving the keys'
defaults), then nodes in `G.nodes(data=True)` order, then edges in
`G.edges(data=True)` order (with keys on a multigraph); key ids d0, d1, ...
in first-seen order of (name, GraphML type, scope), listed last-first;
each value's GraphML type from its Python type by networkx's own table
(`GraphML.construct_types`), and its text `str(value)`.

A file is handed whole to `nx.write_graphml` (same bytes, networkx's
speed) where a value's type is outside that table, an attribute name
or the graph id is not a string, a string holds a character XML 1.0
does not allow (ElementTree writes it raw, lxml raises), or `path` is
not a plain file path (a file object, or .gz/.gzip/.bz2, which networkx
compresses).

Counters of the innermost open call (utils/log.py): `graphml.files` (files
written here), `graphml.delegated` (files handed to `nx.write_graphml`) and
`graphml.bytes` (bytes written by either).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
from typing import Optional

import networkx as nx
from networkx.readwrite import graphml as nx_graphml

from hinge_tpu_torch.utils.log import count


def _xml_types() -> dict:
    g = nx_graphml.GraphML()
    g.construct_types()
    return g.xml_type


#: Python type -> GraphML attr.type, networkx's table
XML_TYPE = _xml_types()
#: characters XML 1.0 does not allow
_NOT_XML = re.compile("[\x00-\x08\x0b\x0c\x0e-\x1f\ud800-\udfff\ufffe\uffff]")
_COMPRESSED = (".gz", ".gzip", ".bz2")
_ROOT = (
    "<?xml version='1.0' encoding='utf-8'?>\n"
    f'<graphml xmlns="{nx_graphml.GraphML.NS_GRAPHML}" '
    f'xmlns:xsi="{nx_graphml.GraphML.NS_XSI}" '
    f'xsi:schemaLocation="{nx_graphml.GraphML.SCHEMALOCATION}">'
)


class _Unsupported(Exception):
    """A value this writer does not emit: the file goes to networkx."""


@dataclasses.dataclass(frozen=True)
class Layout:
    """One networkx serializer's text: indentation, empty elements and
    escapes.  Templates take `{}` fields in the order of their tags'
    attributes."""

    root: str
    key: str
    key_default: str
    graph_open: str
    graph_empty: str
    graph_close: str
    graph_data_first: bool
    graph_indent: str
    node_open: str
    node_empty: str
    node_close: str
    edge_open: str
    edge_empty: str
    edge_close: str
    item_indent: str
    short_empty: bool
    attr_escapes: tuple
    text_escapes: tuple

    def attr(self, s: str) -> str:
        """`s` as an attribute value."""
        _check(s)
        for c, e in self.attr_escapes:
            if c in s:
                s = s.replace(c, e)
        return s

    def text(self, s: str) -> str:
        """`s` as element text."""
        _check(s)
        for c, e in self.text_escapes:
            if c in s:
                s = s.replace(c, e)
        return s

    def element(self, prefix: str, tag: str, text: str) -> str:
        """`prefix` (`<tag ...>`) closed around `text`."""
        if text:
            return f"{prefix}{self.text(text)}</{tag}>"
        if self.short_empty:
            return prefix[:-1] + " />"
        return f"{prefix}</{tag}>"


_XML_ESCAPES = (("&", "&amp;"), ("<", "&lt;"), (">", "&gt;"))

#: `write_graphml_xml`: ElementTree after GraphMLWriter.indent, two spaces
#: a level, " />", the graph's own data after its edges
ETREE = Layout(
    root=_ROOT + "\n",
    key='  <key id="{}" for="{}" attr.name="{}" attr.type="{}" />\n',
    key_default=('  <key id="{}" for="{}" attr.name="{}" attr.type="{}">\n'
                 "    {}\n  </key>\n"),
    graph_open='  <graph edgedefault="{}"{}>\n',
    graph_empty='  <graph edgedefault="{}"{} />\n</graphml>\n',
    graph_close="  </graph>\n</graphml>\n",
    graph_data_first=False,
    graph_indent="    ",
    node_open='    <node id="{}">\n',
    node_empty='    <node id="{}" />\n',
    node_close="    </node>\n",
    edge_open="    <edge {}>\n",
    edge_empty="    <edge {} />\n",
    edge_close="    </edge>\n",
    item_indent="      ",
    short_empty=True,
    attr_escapes=_XML_ESCAPES + (('"', "&quot;"), ("\r", "&#13;"),
                                 ("\n", "&#10;"), ("\t", "&#09;")),
    text_escapes=_XML_ESCAPES,
)

#: `write_graphml_lxml` with lxml: its incremental writer, each element
#: under <graph> on lines of its own at the margin, children two spaces in
LXML = Layout(
    root=_ROOT,
    key='<key id="{}" for="{}" attr.name="{}" attr.type="{}"/>\n',
    key_default=('<key id="{}" for="{}" attr.name="{}" attr.type="{}">\n'
                 "  {}\n</key>\n"),
    graph_open='<graph edgedefault="{}"{}>',
    graph_empty='<graph edgedefault="{}"{}></graph></graphml>',
    graph_close="</graph></graphml>",
    graph_data_first=True,
    graph_indent="",
    node_open='<node id="{}">\n',
    node_empty='<node id="{}"/>\n',
    node_close="</node>\n",
    edge_open="<edge {}>\n",
    edge_empty="<edge {}/>\n",
    edge_close="</edge>\n",
    item_indent="  ",
    short_empty=False,
    attr_escapes=_XML_ESCAPES + (('"', "&quot;"), ("\r", "&#13;"),
                                 ("\n", "&#10;"), ("\t", "&#9;")),
    text_escapes=_XML_ESCAPES + (("\r", "&#13;"),),
)


def layout() -> Optional[Layout]:
    """The layout `nx.write_graphml` writes on this host now, or None
    where it is bound to neither of networkx's writers."""
    w = nx.write_graphml
    if w is nx_graphml.write_graphml_xml:
        return ETREE
    if w is nx_graphml.write_graphml_lxml:
        try:
            import lxml.etree  # noqa: F401
        except ImportError:
            return ETREE
        return LXML
    return None


def _check(s: str) -> None:
    if _NOT_XML.search(s):
        raise _Unsupported(s)


class _Keys:
    """The file's <key> lines, ids given in first-seen order of (name,
    GraphML type, scope)."""

    def __init__(self, L: Layout):
        self.L = L
        self.ids = {}
        self.lines = []

    def id(self, name: str, xml_type: str, scope: str, default) -> str:
        kid = self.ids.get((name, xml_type, scope))
        if kid is None:
            L = self.L
            kid = self.ids[(name, xml_type, scope)] = f"d{len(self.ids)}"
            args = (kid, scope, L.attr(name), xml_type)
            if default is None:
                self.lines.append(L.key.format(*args))
            else:
                self.lines.append(L.key_default.format(
                    *args, L.element("<default>", "default", str(default))))
        return kid


class _Scope:
    """The `<data key=...>` prefixes of one scope (graph, node or edge):
    `cache` maps an attribute name to the Python type its prefix was made
    for and the prefix."""

    def __init__(self, keys: _Keys, scope: str, indent: str, default: dict):
        self.keys, self.scope, self.indent = keys, scope, indent
        self.default = default
        self.cache = {}

    def prefix(self, name, t) -> str:
        """Key and cache `name` met with a value of type `t`."""
        xml_type = XML_TYPE.get(t)
        if xml_type is None or type(name) is not str:
            raise _Unsupported(name, t)
        kid = self.keys.id(name, xml_type, self.scope, self.default.get(name))
        p = f'{self.indent}<data key="{kid}">'
        self.cache[name] = (t, p)
        return p


def _data(out: list, L: Layout, d: dict, sc: _Scope) -> None:
    """One item's attributes as `<data>` lines appended to `out`."""
    cache = sc.cache
    for k, v in d.items():
        t = type(v)
        c = cache.get(k)
        p = c[1] if c is not None and c[0] is t else sc.prefix(k, t)
        if t is not str:
            out.append(f"{p}{v!s}</data>\n")
        else:
            out.append(L.element(p, "data", v) + "\n")


def render(G, L: Layout) -> str:
    """The text `nx.write_graphml` writes for G in layout L.  Raises
    _Unsupported where G holds what this writer does not emit."""
    gattr = G.graph
    graph_id = gattr.get("id")
    node_default = gattr.get("node_default", {})
    edge_default = gattr.get("edge_default", {})
    if not (graph_id is None or type(graph_id) is str) or not (
            isinstance(node_default, dict) and isinstance(edge_default, dict)):
        raise _Unsupported(graph_id)
    keys = _Keys(L)

    head = []
    _data(head, L, {k: v for k, v in gattr.items()
                    if k not in ("id", "node_default", "edge_default")},
          _Scope(keys, "graph", L.graph_indent, {}))

    body = []
    add = body.append
    ind = L.item_indent
    node_open, node_empty, node_close = L.node_open, L.node_empty, L.node_close
    ids = {}
    sc = _Scope(keys, "node", ind, node_default)
    for n, d in G.nodes(data=True):
        e = ids[n] = L.attr(str(n))
        if d:
            add(node_open.format(e))
            _data(body, L, d, sc)
            add(node_close)
        else:
            add(node_empty.format(e))

    edge_open, edge_empty, edge_close = L.edge_open, L.edge_empty, L.edge_close
    sc = _Scope(keys, "edge", ind, edge_default)
    if G.is_multigraph():
        edges = ((u, v, f' id="{L.attr(str(k))}"', d)
                 for u, v, k, d in G.edges(data=True, keys=True))
    else:
        edges = ((u, v, "", d) for u, v, d in G.edges(data=True))
    for u, v, eid, d in edges:
        e = f'source="{ids[u]}" target="{ids[v]}"{eid}'
        if d:
            add(edge_open.format(e))
            _data(body, L, d, sc)
            add(edge_close)
        else:
            add(edge_empty.format(e))

    edgedefault = "directed" if G.is_directed() else "undirected"
    gid = "" if graph_id is None else f' id="{L.attr(graph_id)}"'
    out = [L.root]
    out.extend(reversed(keys.lines))
    if not (head or body):
        out.append(L.graph_empty.format(edgedefault, gid))
        return "".join(out)
    out.append(L.graph_open.format(edgedefault, gid))
    if L.graph_data_first:
        out += head
        out += body
    else:
        out += body
        out += head
    out.append(L.graph_close)
    return "".join(out)


def _plain_path(path) -> bool:
    """A path networkx opens with `open(path, "wb")`."""
    if isinstance(path, str):
        return os.path.splitext(path)[1] not in _COMPRESSED
    return isinstance(path, pathlib.Path) and path.suffix not in _COMPRESSED


def write_graphml(G, path) -> None:
    """Write G to `path` as `nx.write_graphml(G, path)` would, byte for
    byte (the module's docstring says how, and when it hands the file to
    networkx)."""
    L = layout()
    text = None
    if L is not None and _plain_path(path):
        try:
            text = render(G, L)
        except _Unsupported:
            text = None
    if text is None:
        count("graphml.delegated", 1)
        nx.write_graphml(G, path)
        if _plain_path(path):
            count("graphml.bytes", os.path.getsize(path))
        return
    data = text.encode("utf-8")
    with open(path, "wb") as f:
        f.write(data)
    # networkx's writers pop the graph id out of G.graph as they write it
    G.graph.pop("id", None)
    count("graphml.files", 1)
    count("graphml.bytes", len(data))
