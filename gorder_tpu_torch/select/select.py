"""Groan-selection-language (GSL) compatible query engine.

Parses queries like::

    @membrane and element name carbon
    (resname POPC and name r'^C' and not name C15 C34) or resname POPS
    resid 1 to 254
    molwith SatUnsat and not Ignore

into an AST and evaluates them against a `System` to a boolean atom mask.
Behavioral reference: the groan_rs GSL as exercised by the reference corpus
(SURVEY.md §2.6 item 4); the full set of constructs used by gorder configs is
covered: name/resname/resid/serial clauses with multiple values, `a to b` and
`a - b` ranges, regex values `r'...'`, element name/symbol, NDX group
references (bare or via `group`), chain, macros, boolean operators
(and/or/not, &&/||/!), parentheses, `all`, and `molwith`.

Evaluation is vectorized NumPy over the per-atom arrays (host side only).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from ..errors import SelectionError
from ..system import System, distinct_strings
from .elements import ELEMENTS, SYMBOL_TO_NAME, element_symbols, ensure_elements
from .macros import MACROS

# --------------------------------------------------------------------- tokens

_TOKEN_RE = re.compile(
    r"""
    (?P<regex>r'(?:[^'\\]|\\.)*')
  | (?P<quoted>'(?:[^'\\]|\\.)*')
  | (?P<lpar>\()
  | (?P<rpar>\))
  | (?P<and>&&)
  | (?P<or>\|\|)
  | (?P<not>!)
  | (?P<word>[^\s()!&|']+)
    """,
    re.VERBOSE,
)


@dataclass
class Token:
    kind: str   # 'word' | 'regex' | 'quoted' | 'lpar' | 'rpar' | 'and' | 'or' | 'not'
    text: str


def tokenize(query: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(query):
        if query[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(query, pos)
        if not m:
            raise SelectionError(f"could not parse selection query '{query}' at '{query[pos:]}'")
        kind = m.lastgroup
        text = m.group()
        if kind == "regex":
            text = text[2:-1]
        elif kind == "quoted":
            text = text[1:-1]
        tokens.append(Token(kind, text))
        pos = m.end()
    return tokens


# ------------------------------------------------------------------------ AST

class Node:
    def evaluate(self, system: System) -> np.ndarray:  # mask (n_atoms,)
        raise NotImplementedError


@dataclass
class And(Node):
    left: Node
    right: Node

    def evaluate(self, system):
        return self.left.evaluate(system) & self.right.evaluate(system)


@dataclass
class Or(Node):
    left: Node
    right: Node

    def evaluate(self, system):
        return self.left.evaluate(system) | self.right.evaluate(system)


@dataclass
class Not(Node):
    child: Node

    def evaluate(self, system):
        return ~self.child.evaluate(system)


@dataclass
class All(Node):
    def evaluate(self, system):
        return np.ones(system.n_atoms, dtype=bool)


@dataclass
class MolWith(Node):
    """All atoms of every bond-connected molecule containing a matched atom."""

    child: Node

    def evaluate(self, system):
        seed = self.child.evaluate(system)
        if not system.has_bonds():
            return seed.copy()
        labels = _molecule_labels(system)
        hit = np.zeros(labels.max() + 1 if labels.size else 0, dtype=bool)
        if labels.size:
            hit[labels[seed]] = True
            return hit[labels]
        return seed.copy()


@dataclass
class StringClause(Node):
    """name / resname / chain match against literal values and/or regexes."""

    field: str  # 'name' | 'resname' | 'chain' | 'elname' | 'elsymbol'
    values: Sequence[str]
    regexes: Sequence[str]

    def evaluate(self, system):
        if self.field == "name":
            data = system.atom_names
        elif self.field == "resname":
            data = system.resnames
        elif self.field == "chain":
            if system.chains is None:
                return np.zeros(system.n_atoms, dtype=bool)
            data = system.chains
        elif self.field == "elname":
            ensure_elements(system)
            data = system.elements
        elif self.field == "elsymbol":
            data = element_symbols(system)
        else:  # pragma: no cover
            raise SelectionError(f"unknown string field '{self.field}'")

        mask = np.zeros(system.n_atoms, dtype=bool)
        if self.values:
            mask |= np.isin(data, np.array(list(self.values), dtype=data.dtype))
        # each regex runs once per distinct string, spread back over atoms
        distinct = inverse = None
        for rx in self.regexes:
            try:
                compiled = re.compile(rx)
            except re.error as e:
                raise SelectionError(f"invalid regular expression '{rx}': {e}") from None
            if distinct is None:
                distinct, inverse = distinct_strings(data)
            hits = np.array([bool(compiled.search(x)) for x in distinct],
                            dtype=bool)
            mask |= hits[inverse]
        return mask


@dataclass
class NumberClause(Node):
    """resid / serial match against values and inclusive ranges."""

    field: str  # 'resid' | 'serial'
    singles: Sequence[int]
    ranges: Sequence[tuple]  # inclusive (lo, hi)

    def evaluate(self, system):
        data = system.resids if self.field == "resid" else system.serials
        mask = np.zeros(system.n_atoms, dtype=bool)
        if self.singles:
            mask |= np.isin(data, np.array(list(self.singles), dtype=np.int64))
        for lo, hi in self.ranges:
            mask |= (data >= lo) & (data <= hi)
        return mask


@dataclass
class GroupClause(Node):
    names: Sequence[str]
    regexes: Sequence[str] = ()

    def evaluate(self, system):
        mask = np.zeros(system.n_atoms, dtype=bool)
        names = list(self.names)
        for rx in self.regexes:
            compiled = re.compile(rx)
            names.extend([g for g in system.groups if compiled.search(g)])
        for name in names:
            if name not in system.groups:
                # hint wording: src/errors.rs:56-62
                # (TopologyError::InvalidQuery for SelectError::GroupNotFound)
                raise SelectionError(
                    f"group '{name}' does not exist (hint: one of your atom "
                    f"selection queries uses a name for a group not defined "
                    f"in your system; maybe an ndx file is missing?)"
                )
            mask[system.groups[name]] = True
        return mask


@dataclass
class MacroClause(Node):
    macro: str

    def evaluate(self, system):
        try:
            residues = MACROS[self.macro]
        except KeyError:
            raise SelectionError(f"unknown macro '@{self.macro}'") from None
        return np.isin(system.resnames, np.array(sorted(residues), dtype="U12"))


# ------------------------------------------------------------------ molecules

_MOL_CACHE_ATTR = "_molecule_labels_cache"


def _molecule_labels(system: System) -> np.ndarray:
    """Connected-component label per atom (bond graph), cached on the system."""
    cached = getattr(system, _MOL_CACHE_ATTR, None)
    if cached is not None and cached[0] is system.bonds:
        return cached[1]
    labels = connected_components(system.n_atoms, system.bonds)
    object.__setattr__(system, _MOL_CACHE_ATTR, (system.bonds, labels))
    return labels


def connected_components(n_atoms: int, bonds: np.ndarray) -> np.ndarray:
    """Component label per atom (0-based) over the bond list, numbered in
    the order of each component's first atom.

    Whole-array passes: each bond hooks the larger of its two ends' roots
    onto the smaller, then pointer jumping points every atom at its root,
    until no bond joins two roots. Roots only ever move to smaller indices,
    so each component's root ends as its first atom."""
    root = np.arange(n_atoms, dtype=np.int64)
    if n_atoms == 0 or len(bonds) == 0:
        return root
    a = np.asarray(bonds[:, 0], np.int64)
    b = np.asarray(bonds[:, 1], np.int64)
    while True:
        ra, rb = root[a], root[b]
        apart = ra != rb
        if not apart.any():
            break
        ra, rb = ra[apart], rb[apart]
        np.minimum.at(root, np.maximum(ra, rb), np.minimum(ra, rb))
        while True:
            jumped = root[root]
            if np.array_equal(jumped, root):
                break
            root = jumped
    first = root == np.arange(n_atoms)
    return (np.cumsum(first) - 1)[root]


# --------------------------------------------------------------------- parser

_KEYWORDS_NAME = {"name", "atomname"}
_KEYWORDS_RESNAME = {"resname", "residuename"}
_KEYWORDS_RESID = {"resid", "resnum", "residueid", "resindex"}
_KEYWORDS_SERIAL = {"serial", "atomnum", "atomid"}
_KEYWORDS_CHAIN = {"chain"}
_KEYWORDS_ELNAME = {"elname"}
_KEYWORDS_ELSYMBOL = {"elsymbol"}
_BOOLEAN_WORDS = {"and", "or", "not", "to"}
_ALL_KEYWORDS = (
    _KEYWORDS_NAME | _KEYWORDS_RESNAME | _KEYWORDS_RESID | _KEYWORDS_SERIAL
    | _KEYWORDS_CHAIN | _KEYWORDS_ELNAME | _KEYWORDS_ELSYMBOL
    | {"element", "group", "label", "all", "molwith"} | _BOOLEAN_WORDS
)


class _Parser:
    def __init__(self, tokens: List[Token], query: str):
        self.tokens = tokens
        self.query = query
        self.pos = 0

    def peek(self) -> Optional[Token]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def advance(self) -> Token:
        tok = self.peek()
        if tok is None:
            raise SelectionError(f"unexpected end of selection query '{self.query}'")
        self.pos += 1
        return tok

    # expr := and_expr (OR and_expr)*
    def parse_expr(self) -> Node:
        node = self.parse_and()
        while True:
            tok = self.peek()
            if tok and (tok.kind == "or" or (tok.kind == "word" and tok.text.lower() == "or")):
                self.advance()
                node = Or(node, self.parse_and())
            else:
                return node

    def parse_and(self) -> Node:
        node = self.parse_unary()
        while True:
            tok = self.peek()
            if tok and (tok.kind == "and" or (tok.kind == "word" and tok.text.lower() == "and")):
                self.advance()
                node = And(node, self.parse_unary())
            else:
                return node

    def parse_unary(self) -> Node:
        tok = self.peek()
        if tok is None:
            raise SelectionError(f"unexpected end of selection query '{self.query}'")
        if tok.kind == "not" or (tok.kind == "word" and tok.text.lower() == "not"):
            self.advance()
            return Not(self.parse_unary())
        if tok.kind == "word" and tok.text.lower() == "molwith":
            self.advance()
            return MolWith(self.parse_unary())
        return self.parse_primary()

    def parse_primary(self) -> Node:
        tok = self.advance()
        if tok.kind == "lpar":
            node = self.parse_expr()
            closing = self.advance()
            if closing.kind != "rpar":
                raise SelectionError(f"unbalanced parentheses in query '{self.query}'")
            return node
        if tok.kind == "quoted":
            return GroupClause([tok.text])
        if tok.kind != "word":
            raise SelectionError(
                f"unexpected token '{tok.text}' in selection query '{self.query}'"
            )

        word = tok.text
        lower = word.lower()
        if word.startswith("@"):
            return MacroClause(word[1:].lower())
        if lower == "all":
            return All()
        if lower in _KEYWORDS_NAME:
            values, regexes = self.collect_strings()
            return StringClause("name", values, regexes)
        if lower in _KEYWORDS_RESNAME:
            values, regexes = self.collect_strings()
            return StringClause("resname", values, regexes)
        if lower in _KEYWORDS_CHAIN:
            values, regexes = self.collect_strings()
            return StringClause("chain", values, regexes)
        if lower in _KEYWORDS_RESID:
            singles, ranges = self.collect_numbers()
            return NumberClause("resid", singles, ranges)
        if lower in _KEYWORDS_SERIAL:
            singles, ranges = self.collect_numbers()
            return NumberClause("serial", singles, ranges)
        if lower == "element":
            sub = self.advance()
            if sub.kind != "word" or sub.text.lower() not in ("name", "symbol"):
                raise SelectionError(
                    f"expected 'name' or 'symbol' after 'element' in query '{self.query}'"
                )
            values, regexes = self.collect_strings()
            field = "elname" if sub.text.lower() == "name" else "elsymbol"
            _validate_elements(field, values)
            return StringClause(field, values, regexes)
        if lower in _KEYWORDS_ELNAME:
            values, regexes = self.collect_strings()
            _validate_elements("elname", values)
            return StringClause("elname", values, regexes)
        if lower in _KEYWORDS_ELSYMBOL:
            values, regexes = self.collect_strings()
            _validate_elements("elsymbol", values)
            return StringClause("elsymbol", values, regexes)
        if lower in ("group", "label"):
            values, regexes = self.collect_strings()
            return GroupClause(values, regexes)
        # bare word → NDX/registered group reference
        return GroupClause([word])

    # values until a keyword / operator / parenthesis
    def collect_strings(self):
        values: List[str] = []
        regexes: List[str] = []
        while True:
            tok = self.peek()
            if tok is None or tok.kind in ("rpar", "lpar", "and", "or", "not"):
                break
            if tok.kind == "word" and tok.text.lower() in _BOOLEAN_WORDS:
                break
            if tok.kind == "word" and (
                tok.text.lower() in _ALL_KEYWORDS or tok.text.startswith("@")
            ):
                break
            self.advance()
            if tok.kind == "regex":
                regexes.append(tok.text)
            else:
                values.append(tok.text)
        if not values and not regexes:
            raise SelectionError(f"keyword with no values in query '{self.query}'")
        return values, regexes

    def collect_numbers(self):
        singles: List[int] = []
        ranges: List[tuple] = []
        pending: Optional[int] = None
        expect_range_end = False
        while True:
            tok = self.peek()
            if tok is None or tok.kind in ("rpar", "lpar", "and", "or", "not"):
                break
            if tok.kind == "word" and tok.text.lower() in ("and", "or", "not"):
                break
            if tok.kind == "word" and tok.text.lower() in ("to", "-"):
                if pending is None:
                    raise SelectionError(f"range with no start in query '{self.query}'")
                expect_range_end = True
                self.advance()
                continue
            if tok.kind == "word" and (
                tok.text.lower() in (_ALL_KEYWORDS - {"to"}) or tok.text.startswith("@")
            ):
                break
            self.advance()
            text = tok.text
            # allow compact "5-9" ranges
            compact = re.fullmatch(r"(\d+)-(\d+)", text)
            if compact and not expect_range_end:
                if pending is not None:
                    singles.append(pending)
                    pending = None
                ranges.append((int(compact.group(1)), int(compact.group(2))))
                continue
            try:
                number = int(text)
            except ValueError:
                raise SelectionError(
                    f"could not parse number '{text}' in query '{self.query}'"
                ) from None
            if expect_range_end:
                ranges.append((pending, number))
                pending = None
                expect_range_end = False
            else:
                if pending is not None:
                    singles.append(pending)
                pending = number
        if expect_range_end:
            raise SelectionError(f"range with no end in query '{self.query}'")
        if pending is not None:
            singles.append(pending)
        if not singles and not ranges:
            raise SelectionError(f"keyword with no values in query '{self.query}'")
        return singles, ranges


def _validate_elements(field: str, values: Sequence[str]) -> None:
    for v in values:
        if field == "elname" and v.lower() not in ELEMENTS:
            raise SelectionError(f"unknown element name '{v}'")
        if field == "elsymbol" and v.lower() not in SYMBOL_TO_NAME:
            raise SelectionError(f"unknown element symbol '{v}'")


# ----------------------------------------------------------------- public API

def parse_query(query: str) -> Node:
    tokens = tokenize(query)
    if not tokens:
        raise SelectionError("empty selection query")
    parser = _Parser(tokens, query)
    node = parser.parse_expr()
    if parser.peek() is not None:
        raise SelectionError(
            f"unexpected trailing tokens in selection query '{query}': "
            f"'{parser.peek().text}'"
        )
    return node


def select(system: System, query: Union[str, Node]) -> np.ndarray:
    """Evaluate a query → sorted array of 0-based atom indices."""
    node = parse_query(query) if isinstance(query, str) else query
    mask = node.evaluate(system)
    return np.nonzero(mask)[0].astype(np.int64)


def select_mask(system: System, query: Union[str, Node]) -> np.ndarray:
    node = parse_query(query) if isinstance(query, str) else query
    return node.evaluate(system)


def query_uses_elements(query: str) -> bool:
    """True when the query needs element data (triggers lazy guessing),
    mirroring reference behavior (structure.rs:202-246)."""
    try:
        tokens = tokenize(query)
    except SelectionError:
        return False
    for tok in tokens:
        if tok.kind == "word" and tok.text.lower() in ("element", "elname", "elsymbol"):
            return True
    return False
