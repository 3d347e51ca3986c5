"""Label-churn fence at the poll loop's plan compiler.

The port keeps only :class:`LabelFence` of the reference's cardinality
module (the hub's series accountant is not ported): at most ``value_cap``
distinct values per attribution label key, so a kubelet join minting a
fresh ``pod`` per tick degrades to one ``pod="overflow"`` series per
device instead of a series explosion.
"""

from __future__ import annotations

from typing import Mapping

# Distinct label keys the fence tracks at most (the attribution labels are
# three; the bound only stops a buggy caller growing the table).
_FENCE_KEYS_MAX = 64


class LabelFence:
    """At most ``value_cap`` distinct values per label key; the
    (cap+1)-th and later values map to ``overflow``. Known values keep
    passing — series identity for everything admitted before the storm is
    stable. 0 = unfenced.

    Single-threaded writes (the poll loop owns plan compilation);
    counter reads from the exposition path are GIL-atomic."""

    overflow = "overflow"

    def __init__(self, value_cap: int = 0) -> None:
        self.value_cap = max(0, value_cap)
        self._seen: dict[str, set[str]] = {}
        self._fenced: dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.value_cap > 0

    def fence(self, labels: Mapping[str, str]) -> Mapping[str, str]:
        """Admit or overflow each label value. Returns the input
        mapping untouched when nothing fenced (the common case costs a
        set lookup per label, no copy)."""
        if not self.value_cap:
            return labels
        replaced: dict[str, str] | None = None
        for key, value in labels.items():
            if not value or value == self.overflow:
                continue
            seen = self._seen.get(key)
            if seen is None:
                if len(self._seen) >= _FENCE_KEYS_MAX:
                    continue
                seen = self._seen[key] = set()
            if value in seen:
                continue
            if len(seen) < self.value_cap:
                seen.add(value)
                continue
            self._fenced[key] = self._fenced.get(key, 0) + 1
            if replaced is None:
                replaced = dict(labels)
            replaced[key] = self.overflow
        return replaced if replaced is not None else labels

    def fenced_totals(self) -> dict[str, int]:
        return dict(self._fenced)
