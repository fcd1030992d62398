"""Circom `.r1cs` (iden3 binary format v1) + `.sym` importer.

Behavioral parity with upstream zksnake: python/zksnake/parser.py: same section
dispatch (1 = header, 2 = constraints, 3 = wire-to-label), same a*b == c
equation construction including the fresh-wire election heuristic (its
parser.py:88-157), and the same default wire naming (out/pub/priv/v) when no
symfile is given (:179-201). The implementation is original: sections are
decoded through a small binary cursor and linear combinations are parsed to
(wire_id, factor) term lists before any symbolic objects are built.
"""

import csv
import sys
from io import BytesIO
from pathlib import Path

from .arithmetization import symbolic as circuit

SUPPORTED_VERSIONS = (1,)

_SEC_HEADER = 1
_SEC_CONSTRAINTS = 2
_SEC_WIRE2LABEL = 3


class _Cursor:
    """Little-endian reader over a byte buffer."""

    def __init__(self, stream):
        self._s = stream

    def u32(self):
        return int.from_bytes(self._s.read(4), "little")

    def u64(self):
        return int.from_bytes(self._s.read(8), "little")

    def scalar(self, width):
        return int.from_bytes(self._s.read(width), "little")

    def take(self, n):
        return self._s.read(n)

    def at_end_u64(self):
        raw = self._s.read(8)
        return (True, 0) if not raw else (False, int.from_bytes(raw, "little"))


class R1CSReader:
    def __init__(self, r1csfile: str, symfile: str = None):
        self.reader = Path(r1csfile).open("rb")
        self.version = None
        self.n_section = None
        self.header = {}
        self.wire_label_map = {}
        self.wires = []
        self.raw_constraints = []
        self.constraints = []

        self.symbol_map = {}
        if symfile:
            with Path(symfile).open("r", encoding="utf-8") as f:
                self._load_symbols(f)

    def _load_symbols(self, file):
        # circom .sym rows: label, wire index, component, qualified name
        self.symbol_map["0"] = (0, 1)
        for label, index, _, name in csv.reader(file, delimiter=","):
            self.symbol_map[label] = (index, name)

    def _parse_preamble(self, cur: _Cursor):
        magic = cur.take(4)
        if magic != b"r1cs":
            raise ValueError(f"Invalid magic bytes: {magic}")
        self.version = cur.u32()
        self.n_section = cur.u32()
        if self.version not in SUPPORTED_VERSIONS:
            raise ValueError(f"Unsupported r1cs file version: {self.version}")

    def _parse_sections(self, cur: _Cursor):
        while True:
            raw_type = cur.take(4)
            section_type = int.from_bytes(raw_type, "little") if raw_type else 0
            if section_type == 0:
                break
            size = cur.u64()
            body = BytesIO(cur.take(size))
            if section_type == _SEC_HEADER:
                self._parse_header_body(_Cursor(body))
            elif section_type == _SEC_CONSTRAINTS:
                self.raw_constraints.append(body)
            elif section_type == _SEC_WIRE2LABEL:
                self._parse_wire_labels(_Cursor(body))

    def _parse_header_body(self, cur: _Cursor):
        fs = cur.u32()
        self.header = {
            "fs": fs,
            "prime": cur.scalar(fs),
            "n_wires": cur.u32(),
            "n_pub_out": cur.u32(),
            "n_pub_in": cur.u32(),
            "n_priv_in": cur.u32(),
            "n_labels": cur.u64(),
            "m_constraints": cur.u32(),
        }

    def _parse_wire_labels(self, cur: _Cursor):
        index = 0
        while True:
            done, label = cur.at_end_u64()
            if done:
                break
            self.wire_label_map[index] = label
            index += 1

    # -- constraint reconstruction ---------------------------------------

    def _read_terms(self, cur: _Cursor):
        """One linear combination: [(wire_id, factor), ...] in stream order."""
        return [
            (cur.u32(), cur.scalar(self.header["fs"]))
            for _ in range(cur.u32())
        ]

    def _terms_to_expr(self, terms):
        """Fold terms into a symbolic sum (0 for an empty combination)."""
        expr = 0
        for wire_id, factor in terms:
            contrib = factor * self.wires[wire_id]
            expr = contrib if isinstance(expr, int) and expr == 0 else expr + contrib
        return expr

    @staticmethod
    def _elect_target(terms, taken):
        """Pick the wire of C's combination that this constraint *defines*.

        Streaming election (identical to the reference's heuristic): the
        first term is provisionally the target; any later term with a larger
        wire id that is not yet defined by an earlier constraint takes over,
        displacing the previous candidate into the plain sum. Every candidate
        is marked taken the moment it is elected — including displaced ones.
        """
        target = None
        rest = []
        for wire_id, factor in terms:
            if target is None:
                target = (wire_id, factor)
                taken.add(wire_id)
            elif wire_id > target[0] and wire_id not in taken:
                rest.append(target)
                target = (wire_id, factor)
                taken.add(wire_id)
            else:
                rest.append((wire_id, factor))
        return target, rest

    def _decode_constraints(self, body: BytesIO):
        cur = _Cursor(body)
        taken = set()
        for _ in range(self.header["m_constraints"]):
            a_expr = self._terms_to_expr(self._read_terms(cur))
            b_expr = self._terms_to_expr(self._read_terms(cur))
            c_terms = self._read_terms(cur)

            target, rest = self._elect_target(c_terms, taken)
            rest_expr = self._terms_to_expr(rest)
            if target is None:
                lhs = 0
            else:
                wire_id, factor = target
                lhs = factor * self.wires[wire_id]
            if not (isinstance(rest_expr, int) and rest_expr == 0):
                lhs = lhs + rest_expr

            self.constraints.append(lhs == a_expr * b_expr)

    def _build_wires(self):
        n_wires = self.header["n_wires"]
        if self.symbol_map:
            self.wires = [1] + [None] * (n_wires - 1)
            for index, name in self.symbol_map.values():
                if int(index) > 0:
                    self.wires[int(index)] = circuit.Field(name)
        else:
            # canonical circom ordering: 1, outputs, public, private, temps
            def named(prefix, count):
                return [circuit.Field(f"{prefix}{i + 1}") for i in range(count)]

            h = self.header
            n_temp = n_wires - h["n_pub_out"] - h["n_pub_in"] - h["n_priv_in"] - 1
            self.wires = (
                [1]
                + named("out", h["n_pub_out"])
                + named("pub", h["n_pub_in"])
                + named("priv", h["n_priv_in"])
                + named("v", n_temp)
            )

    def read(self):
        # Linear combinations build left-deep expression chains; deep circuits
        # need headroom over the default recursion limit.
        if sys.getrecursionlimit() < 100000:
            sys.setrecursionlimit(100000)

        cur = _Cursor(self.reader)
        self._parse_preamble(cur)
        self._parse_sections(cur)
        self._build_wires()
        for body in self.raw_constraints:
            self._decode_constraints(body)
        self.reader.close()

        return {
            "header": self.header,
            "wires": self.wires,
            "constraints": self.constraints,
        }
