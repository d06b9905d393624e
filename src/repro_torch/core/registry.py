"""Generic name → item registry.

The repo addresses three open-ended axes by name — mapping policies,
workload scenarios, and fleet builders — and all three want the same
behaviour: case-insensitive lookup, refuse-to-shadow registration,
helpful unknown-name errors listing what *is* registered.
:class:`NameRegistry` implements that once; each axis instantiates it
with its label, case convention, and item check, and keeps its existing
module-level function surface as thin wrappers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class NameRegistry:
    """A mutable, case-insensitive mapping from names to items.

    Args:
      label: what an item is called in error messages ("policy",
        "scenario", "fleet", ...).
      case: canonical-form function (``str.upper`` or ``str.lower``).
      check: optional ``check(name, item)`` raising TypeError for items
        that don't belong in this registry.
    """

    def __init__(self, label: str, *, case: Callable[[str], str] = str.upper,
                 check: Optional[Callable[[str, Any], None]] = None):
        self._label = label
        self._case = case
        self._check = check
        self._items: Dict[str, Any] = {}

    def canon(self, name: str) -> str:
        if not isinstance(name, str) or not name.strip():
            raise ValueError(
                f"{self._label} name must be a non-empty string, "
                f"got {name!r}"
            )
        return self._case(name.strip())

    def register(self, name: str, item, *, overwrite: bool = False):
        """Register ``item`` under ``name`` (case-insensitive).

        Re-registering an existing name raises unless ``overwrite=True``
        — silently shadowing a built-in (or a colleague's entry) is the
        kind of spooky action a registry should refuse by default.

        Returns the item, so registration can be used expression-style.
        """
        key = self.canon(name)
        if self._check is not None:
            self._check(name, item)
        if key in self._items and not overwrite:
            raise ValueError(
                f"{self._label} {name!r} is already registered; pass "
                f"overwrite=True to replace it"
            )
        self._items[key] = item
        return item

    def unregister(self, name: str) -> None:
        """Remove a registered item (KeyError if absent)."""
        key = self.canon(name)
        if key not in self._items:
            raise KeyError(f"{self._label} {name!r} is not registered")
        del self._items[key]

    def is_registered(self, name: str) -> bool:
        try:
            return self.canon(name) in self._items
        except ValueError:
            return False

    def get(self, name: str):
        """Resolve an item by (case-insensitive) name, or raise KeyError
        listing every registered name."""
        try:
            return self._items[self.canon(name)]
        except KeyError:
            raise KeyError(
                f"unknown {self._label} {name!r}; "
                f"choose from {self.names()}"
            ) from None

    def names(self) -> List[str]:
        """Sorted names of every registered item."""
        return sorted(self._items)
