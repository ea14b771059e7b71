"""Minimal GDL (graph-definition-language) parser for tests.

The port's own copy of ``graph_tpu.io.gdl`` (pure Python; the same
parser).  Reference analog: the ``gdl`` feature
(crates/builder/src/input/gdl.rs:16-208) which wraps the external
``gdl`` crate.  This is a small recursive-descent parser covering the
subset the reference's tests use:

* ``(a)-->()-->()<--(a)``            — named/anonymous nodes, both arrows
* ``(a:Label)``                      — labels (parsed, retained)
* ``(a { value: 42 })``              — node properties → node values
* ``(a)-[{cost: 4.0}]->(b)``         — relationship property → edge value
* elements separated by commas and/or whitespace

Node ids are assigned in order of first appearance (matching the gdl
crate's variable semantics relied on by the golden tests,
e.g. algos/src/page_rank.rs:175-197).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from graph_tpu_torch.errors import GraphError

_TOKEN = re.compile(
    r"""
    (?P<lparen>\()
  | (?P<rparen>\))
  | (?P<arrow_r>-\s*->|-->)
  | (?P<arrow_l><--|<-)
  | (?P<edge_open>-\[)
  | (?P<edge_close_r>\]\s*->)
  | (?P<edge_close_l>\]\s*-)
  | (?P<lbrace>\{)
  | (?P<rbrace>\})
  | (?P<colon>:)
  | (?P<comma>,)
  | (?P<dash>-)
  | (?P<number>[0-9]+\.[0-9]+|[0-9]+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<ws>\s+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise GraphError(f"GDL parse error at {text[pos:pos+20]!r}")
        kind = m.lastgroup
        if kind != "ws":
            tokens.append((kind, m.group()))
        pos = m.end()
    return tokens


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0
        self.node_ids: Dict[str, int] = {}
        self.next_id = 0
        self.node_values: Dict[int, float] = {}
        self.node_labels: Dict[int, List[str]] = {}
        self.edges: List[Tuple[int, int, Optional[float]]] = []

    def peek(self):
        return self.tokens[self.i][0] if self.i < len(self.tokens) else None

    def eat(self, kind):
        if self.peek() != kind:
            got = self.tokens[self.i] if self.i < len(self.tokens) else "EOF"
            raise GraphError(f"GDL: expected {kind}, got {got}")
        tok = self.tokens[self.i]
        self.i += 1
        return tok[1]

    def parse(self):
        while self.peek() is not None:
            if self.peek() == "comma":
                self.eat("comma")
                continue
            self.element()
        return self

    def element(self):
        left = self.node()
        while self.peek() in ("arrow_r", "arrow_l", "edge_open", "dash"):
            direction, value = self.edge()
            right = self.node()
            if direction == "r":
                self.edges.append((left, right, value))
            else:
                self.edges.append((right, left, value))
            left = right

    def node(self) -> int:
        self.eat("lparen")
        name = None
        if self.peek() == "name":
            name = self.eat("name")
        labels = []
        while self.peek() == "colon":
            self.eat("colon")
            labels.append(self.eat("name"))
        props = self.props() if self.peek() == "lbrace" else {}
        self.eat("rparen")

        if name is not None and name in self.node_ids:
            nid = self.node_ids[name]
        else:
            nid = self.next_id
            self.next_id += 1
            if name is not None:
                self.node_ids[name] = nid
        if labels:
            self.node_labels.setdefault(nid, []).extend(labels)
        if props:
            # single-value node property becomes the node value
            self.node_values[nid] = float(next(iter(props.values())))
        return nid

    def edge(self) -> Tuple[str, Optional[float]]:
        kind = self.peek()
        if kind == "arrow_r":
            self.eat("arrow_r")
            return "r", None
        if kind == "arrow_l":
            # '<--' or '<-' ... '-': consume optional trailing dash form
            self.eat("arrow_l")
            if self.peek() == "edge_open":
                # '<-[ ... ]-'
                value = self._edge_body()
                self.eat("edge_close_l")
                return "l", value
            if self.peek() == "dash":
                self.eat("dash")
            return "l", None
        if kind == "edge_open":
            value = self._edge_body()
            self.eat("edge_close_r")
            return "r", value
        if kind == "dash":
            self.eat("dash")
            if self.peek() == "edge_open":
                value = self._edge_body()
                self.eat("edge_close_r")
                return "r", value
            raise GraphError("GDL: unexpected '-'")
        raise GraphError(f"GDL: unexpected edge token {kind}")

    def _edge_body(self) -> Optional[float]:
        self.eat("edge_open")
        if self.peek() == "name":
            self.eat("name")  # relationship variable
        while self.peek() == "colon":
            self.eat("colon")
            self.eat("name")  # relationship type
        value = None
        if self.peek() == "lbrace":
            props = self.props()
            if props:
                value = float(next(iter(props.values())))
        return value

    def props(self) -> Dict[str, float]:
        self.eat("lbrace")
        out = {}
        while self.peek() != "rbrace":
            key = self.eat("name")
            self.eat("colon")
            out[key] = float(self.eat("number"))
            if self.peek() == "comma":
                self.eat("comma")
        self.eat("rbrace")
        return out


def parse_gdl(text: str):
    """Parse GDL into (src, dst, values, node_count).

    ``values`` is None unless any relationship carries a property.
    """
    p = _Parser(_tokenize(text)).parse()
    node_count = p.next_id
    if not p.edges:
        return (
            np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.int64),
            None,
            node_count,
        )
    src = np.asarray([e[0] for e in p.edges], dtype=np.int64)
    dst = np.asarray([e[1] for e in p.edges], dtype=np.int64)
    has_values = any(e[2] is not None for e in p.edges)
    values = (
        np.asarray([e[2] if e[2] is not None else 0.0 for e in p.edges], dtype=np.float32)
        if has_values
        else None
    )
    return src, dst, values, node_count
