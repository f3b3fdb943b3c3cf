"""Id interning — the host boundary between ids and device row indices.

Source/market ids (or (source, market) pair keys) are interned once at
ingest into stable rows; every device-side structure (reliability tensors,
slot blocks) is keyed by row index, and ids are rehydrated only on the host.

The pure-Python half of ``bayesian_consensus_engine_tpu/utils/interning.py``:
the JAX package pins this interner bit-identical to its C extension
(``tests/test_pipeline.py::test_python_interning_fallback_identical``), so
the port assigns the same rows in the same order without native code.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Sequence

import numpy as np


class IdInterner:
    """Bidirectional key ↔ row map with first-seen row assignment."""

    __slots__ = ("_to_row", "_to_id")

    def __init__(self) -> None:
        self._to_row: Dict[Hashable, int] = {}
        self._to_id: List[Hashable] = []

    def __len__(self) -> int:
        return len(self._to_id)

    def __contains__(self, identifier: Hashable) -> bool:
        return identifier in self._to_row

    def intern(self, identifier: Hashable) -> int:
        """Return the row for *identifier*, assigning the next row if new."""
        row = self._to_row.get(identifier)
        if row is None:
            row = len(self._to_id)
            self._to_row[identifier] = row
            self._to_id.append(identifier)
        return row

    def intern_all(self, identifiers: Iterable[Hashable]) -> List[int]:
        return [self.intern(i) for i in identifiers]

    def lookup(self, identifier: Hashable) -> int:
        """Row for an already-interned id; raises KeyError if unknown."""
        return self._to_row[identifier]

    def get(self, identifier: Hashable, default: int = -1) -> int:
        return self._to_row.get(identifier, default)

    def id_of(self, row: int) -> Hashable:
        return self._to_id[row]

    def ids(self) -> List[Hashable]:
        """All interned keys in row order (a copy)."""
        return list(self._to_id)

    def items(self):
        """(key, row) pairs."""
        return self._to_row.items()

    # Batch forms (array-returning); keys here are (a, b) string pairs.
    def intern_arrays(
        self, sources: Sequence[str], markets: Sequence[str]
    ) -> np.ndarray:
        return np.asarray(
            [self.intern((s, m)) for s, m in zip(sources, markets)],
            dtype=np.int32,
        )

    def lookup_arrays(
        self, sources: Sequence[str], markets: Sequence[str]
    ) -> np.ndarray:
        return np.asarray(
            [self.get((s, m)) for s, m in zip(sources, markets)], dtype=np.int32
        )


def make_pair_interner() -> IdInterner:
    """The (source, market) → row interner of a store."""
    return IdInterner()
