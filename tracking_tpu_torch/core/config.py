"""Config base class and its OpenCV-XML files, counterpart of
``tracking_tpu/core/config.py``.

Each algorithm's config is a frozen dataclass whose field names are the
reference's XML parameter names, so the reference's ``config/*.xml`` files
read unchanged. Files written here equal the JAX package's byte for byte
(``saveConfig`` parity, ``FrameDifferenceBGS.cpp:63-83``)."""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Any, Type, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class BGSConfig:
    """Base class for all algorithm configs (frozen, hence hashable)."""

    xml_name: str = dataclasses.field(default="", init=False, repr=False)

    def replace(self: T, **kwargs: Any) -> T:
        return dataclasses.replace(self, **kwargs)


def _parse_value(text: str, pytype: type) -> Any:
    text = (text or "").strip()
    if pytype is bool:
        # CvFileStorage writes bools as ints (cvWriteInt of a bool)
        return bool(int(float(text)))
    if pytype is int:
        return int(float(text))
    if pytype is float:
        return float(text)
    if text.startswith('"') and text.endswith('"') and len(text) >= 2:
        return text[1:-1]  # CvFileStorage quotes strings ("" = empty)
    return text


def _format_value(value: Any) -> str:
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, float):
        return repr(value)
    return str(value)


def config_from_xml(cls: Type[T], path: str, **overrides: Any) -> T:
    """A config dataclass from an OpenCV-storage XML file. Missing
    parameters keep the dataclass defaults (``cvReadIntByName(fs, 0, name,
    default)``, ``FrameDifferenceBGS.cpp:74-83``); unknown entries are
    ignored."""
    values: dict[str, Any] = {}
    if path and os.path.exists(path):
        root = ET.parse(path).getroot()
        # <opencv_storage><param>value</param>...</opencv_storage>
        fields = {f.name: f for f in dataclasses.fields(cls) if f.init}
        for child in root:
            if child.tag in fields:
                ftype = fields[child.tag].type
                pytype = {"bool": bool, "int": int, "float": float, "str": str}.get(
                    ftype if isinstance(ftype, str) else ftype.__name__, str
                )
                values[child.tag] = _parse_value(child.text, pytype)
    values.update(overrides)
    return cls(**values)


def config_to_xml(config: Any, path: str) -> None:
    """Write a config dataclass as OpenCV-storage XML (``saveConfig``)."""
    root = ET.Element("opencv_storage")
    for f in dataclasses.fields(config):
        if not f.init:
            continue
        el = ET.SubElement(root, f.name)
        el.text = _format_value(getattr(config, f.name))
    tree = ET.ElementTree(root)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b'<?xml version="1.0"?>\n')
        tree.write(fh)
        fh.write(b"\n")
