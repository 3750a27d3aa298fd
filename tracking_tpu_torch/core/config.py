"""Config base class, counterpart of ``tracking_tpu/core/config.py``.

Each algorithm's config is a frozen dataclass whose field names are the
reference's XML parameter names."""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class BGSConfig:
    """Base class for all algorithm configs (frozen, hence hashable)."""

    xml_name: str = dataclasses.field(default="", init=False, repr=False)

    def replace(self: T, **kwargs: Any) -> T:
        return dataclasses.replace(self, **kwargs)
