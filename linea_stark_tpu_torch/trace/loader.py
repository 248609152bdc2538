"""CBOR trace file loading (reference format).

The reference reads column files produced by an external Linea corset-style
tool: CBOR maps holding 32-byte big-endian scalars
(``RawLookupTrace::read_file`` trace/src/lookup.rs:20-43,
``RawPermutationTrace::read_file`` trace/src/permutation.rs:17-22).  Values
decode via big-endian reduction mod r (SURVEY.md §5.9.5).

Schemas (serde struct -> CBOR map; [u8;32] -> array of 32 u8, which cbor2
yields as ``list[int]`` — ``bytes`` also accepted):

    RawPermutationTrace { a: [[bytes32]], b: [[bytes32]], name: str }
    RawLookupTrace     { a: [[bytes32]], b: [[[bytes32]]], name: str,
                         a_filter: [bytes32], b_filter: [[bytes32]] }

Missing filters default to one, per the reference's read-time fixup
(trace/src/lookup.rs:25-41).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

try:
    import cbor2
except ImportError:
    from ..utils import cbor as cbor2  # pure-Python fallback (same API subset)

ONE_BYTES = bytes(31) + b"\x01"


def _to_bytes32(v) -> bytes:
    if isinstance(v, (bytes, bytearray)):
        assert len(v) == 32
        return bytes(v)
    return bytes(v)  # list of ints


def _col_to_np(col) -> np.ndarray:
    if len(col) == 0:
        return np.zeros((0, 32), dtype=np.uint8)
    return np.stack([np.frombuffer(_to_bytes32(v), dtype=np.uint8) for v in col])


def _np_to_col(arr: np.ndarray) -> list:
    return [arr[i].tobytes() for i in range(arr.shape[0])]


def _resize_col(col: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad (or truncate) to `size` rows — matches Vec::resize with
    [0u8;32] (trace/src/permutation.rs:134-142)."""
    n = col.shape[0]
    if n == size:
        return col
    if n > size:
        return col[:size]
    pad = np.zeros((size - n, 32), dtype=np.uint8)
    return np.concatenate([col, pad], axis=0)


@dataclass
class RawPermutationTrace:
    a: list  # list of (N, 32) uint8 arrays, one per column
    b: list
    name: str = ""

    @classmethod
    def read_file(cls, path: str) -> "RawPermutationTrace":
        with open(path, "rb") as f:
            d = cbor2.load(f)
        return cls(
            a=[_col_to_np(c) for c in d["a"]],
            b=[_col_to_np(c) for c in d["b"]],
            name=d.get("name", ""),
        )

    def write_file(self, path: str) -> None:
        with open(path, "wb") as f:
            cbor2.dump(
                {
                    "a": [[list(r) for r in _np_to_col(c)] for c in self.a],
                    "b": [[list(r) for r in _np_to_col(c)] for c in self.b],
                    "name": self.name,
                },
                f,
            )

    def get_max_height(self) -> int:
        return max([c.shape[0] for c in self.a + self.b] or [0])

    def resize(self, size: int) -> None:
        self.a = [_resize_col(c, size) for c in self.a]
        self.b = [_resize_col(c, size) for c in self.b]


@dataclass
class RawLookupTrace:
    a: list            # list of (N, 32) arrays
    b: list            # list (per table) of lists of (N, 32) arrays
    name: str = ""
    a_filter: np.ndarray | None = None      # (N, 32) or None
    b_filter: list = field(default_factory=list)  # per table, (N, 32) or None

    @classmethod
    def read_file(cls, path: str) -> "RawLookupTrace":
        with open(path, "rb") as f:
            d = cbor2.load(f)
        t = cls(
            a=[_col_to_np(c) for c in d["a"]],
            b=[[_col_to_np(c) for c in tbl] for tbl in d["b"]],
            name=d.get("name", ""),
            a_filter=_col_to_np(d.get("a_filter", [])),
            b_filter=[_col_to_np(fcol) for fcol in d.get("b_filter", [])],
        )
        t.default_filters()
        return t

    def default_filters(self) -> None:
        """Append enabled (=1) filter rows where filters are missing/short
        (trace/src/lookup.rs:25-41)."""
        height_a = self.a[0].shape[0]
        one = np.frombuffer(ONE_BYTES, dtype=np.uint8)
        if self.a_filter is None or self.a_filter.shape[0] == 0:
            self.a_filter = np.tile(one, (height_a, 1))
        elif self.a_filter.shape[0] < height_a:
            fill = np.tile(one, (height_a - self.a_filter.shape[0], 1))
            self.a_filter = np.concatenate([self.a_filter, fill])
        while len(self.b_filter) < len(self.b):
            self.b_filter.append(np.zeros((0, 32), dtype=np.uint8))
        for i, tbl in enumerate(self.b):
            h = tbl[0].shape[0]
            if self.b_filter[i].shape[0] < h:
                fill = np.tile(one, (h - self.b_filter[i].shape[0], 1))
                self.b_filter[i] = np.concatenate([self.b_filter[i], fill])

    def write_file(self, path: str) -> None:
        with open(path, "wb") as f:
            cbor2.dump(
                {
                    "a": [[list(r) for r in _np_to_col(c)] for c in self.a],
                    "b": [
                        [[list(r) for r in _np_to_col(c)] for c in tbl]
                        for tbl in self.b
                    ],
                    "name": self.name,
                    "a_filter": [list(r) for r in _np_to_col(self.a_filter)]
                    if self.a_filter is not None
                    else [],
                    "b_filter": [
                        [list(r) for r in _np_to_col(fcol)] for fcol in self.b_filter
                    ],
                },
                f,
            )

    def get_max_height(self) -> int:
        hs = [c.shape[0] for c in self.a]
        for tbl in self.b:
            hs.extend(c.shape[0] for c in tbl)
        return max(hs or [0])

    def resize(self, size: int) -> None:
        self.a = [_resize_col(c, size) for c in self.a]
        self.a_filter = _resize_col(self.a_filter, size)
        self.b = [[_resize_col(c, size) for c in tbl] for tbl in self.b]
        self.b_filter = [_resize_col(fcol, size) for fcol in self.b_filter]
