"""OpenCV FileStorage YAML (subset) reader and writer.

cv::FileStorage writes the template banks as a YAML 1.0 dialect with a
nonstandard ``%YAML:1.0`` directive and ``!!opencv-matrix`` tagged
mappings ``{rows, cols, dt, data}``.  The writer half is plain Python and
numpy and emits OpenCV-style YAML that cv2.FileStorage and cv::linemod
read back; it is what the bank writers need and runs anywhere.  The
reader half parses with PyYAML (after normalizing the directive and tag)
and imports it only inside `loads`: it is the fallback of the bank
readers where the native loader (``utils/native.py``) cannot build.
"""

from __future__ import annotations

import io
from typing import Any

import numpy as np

_DT_TO_NUMPY = {
    "u": np.uint8,
    "c": np.int8,
    "w": np.uint16,
    "s": np.int16,
    "i": np.int32,
    "f": np.float32,
    "d": np.float64,
}
_NUMPY_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NUMPY.items()}


class CvMatrix:
    """Marker wrapper so the emitter writes ``!!opencv-matrix`` nodes."""

    def __init__(self, array: np.ndarray):
        self.array = np.asarray(array)
        if self.array.ndim == 1:
            self.array = self.array[None, :]
        if self.array.ndim != 2:
            raise ValueError("opencv-matrix must be 2-D")


class BlockRows(list):
    """Marker: a list of short rows emitted as a block sequence of flow
    sequences — FileStorage's style for per-item ``write(fs) << "[:" ...``
    members, e.g. cv::linemod Feature lists::

        features:
           - [ 14, 2, 4 ]
           - [ 22, 2, 4 ]
    """


def _cv_loader():
    """PyYAML's safe loader (the libyaml one where built: ~10x faster on a
    2 MB bank) with the ``!!opencv-matrix`` constructor."""
    import yaml

    base = getattr(yaml, "CSafeLoader", yaml.SafeLoader)

    class CvLoader(base):
        pass

    def matrix(loader, node):
        mapping = loader.construct_mapping(node, deep=True)
        arr = np.array(mapping["data"], dtype=_DT_TO_NUMPY[mapping["dt"]])
        return arr.reshape(mapping["rows"], mapping["cols"])

    CvLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", matrix)
    return CvLoader


def loads(text: str) -> dict[str, Any]:
    """Parse OpenCV-YAML text into {key: value} with np.ndarray matrices
    (needs PyYAML)."""
    import yaml

    lines = text.splitlines()
    if lines and lines[0].startswith("%YAML"):
        lines = lines[1:]  # the bare '---' document marker that follows stays
    out = yaml.load("\n".join(lines), Loader=_cv_loader())
    return out if out is not None else {}


def load(path: str) -> dict[str, Any]:
    with open(path, "r") as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# Emitter (OpenCV FileStorage style)
# ---------------------------------------------------------------------------


def _fmt_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        f = float(v)
        if f == int(f) and abs(f) < 1e15:
            # OpenCV writes integral floats as "1." to keep the float type.
            return f"{int(f)}."
        return np.format_float_scientific(f, precision=16, trim="-")
    if isinstance(v, str):
        if v == "" or any(c in v for c in ":{}[]#&*!|>'\"%@`,") or v.strip() != v:
            return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
        return v
    raise TypeError(f"cannot format scalar of type {type(v)}")


def _wrap_flow(items: list[str], indent: str, width: int = 70) -> str:
    """Flow sequence '[ a, b, ... ]' wrapped at `width` like FileStorage."""
    out_lines: list[str] = []
    cur = "[ "
    for i, it in enumerate(items):
        piece = it + (", " if i + 1 < len(items) else " ]")
        if len(indent) + len(cur) + len(piece) > width and cur.strip() != "[":
            out_lines.append(cur.rstrip())
            cur = "    " + piece
        else:
            cur += piece
    if not items:
        cur = "[]"
    out_lines.append(cur.rstrip())
    return ("\n" + indent).join(out_lines)


def _emit_value(buf: io.StringIO, key: str, v: Any, depth: int) -> None:
    indent = "   " * depth
    if isinstance(v, CvMatrix) or (isinstance(v, np.ndarray) and v.ndim == 2):
        arr = v.array if isinstance(v, CvMatrix) else v
        dt = _NUMPY_TO_DT[arr.dtype]
        buf.write(f"{indent}{key}: !!opencv-matrix\n")
        ind2 = "   " * (depth + 1)
        buf.write(f"{ind2}rows: {arr.shape[0]}\n")
        buf.write(f"{ind2}cols: {arr.shape[1]}\n")
        buf.write(f"{ind2}dt: {dt}\n")
        items = [_fmt_scalar(x) for x in arr.flatten().tolist()]
        buf.write(f"{ind2}data: {_wrap_flow(items, ind2 + '   ')}\n")
    elif isinstance(v, dict):
        buf.write(f"{indent}{key}:\n")
        for k2, v2 in v.items():
            _emit_value(buf, k2, v2, depth + 1)
    elif isinstance(v, BlockRows):
        if not v:
            buf.write(f"{indent}{key}: []\n")
        else:
            buf.write(f"{indent}{key}:\n")
            for row in v:
                buf.write(
                    f"{indent}   - [ " + ", ".join(_fmt_scalar(x) for x in row) + " ]\n"
                )
    elif isinstance(v, (list, tuple, np.ndarray)):
        seq = list(v.tolist()) if isinstance(v, np.ndarray) else list(v)
        if seq and isinstance(seq[0], dict):
            buf.write(f"{indent}{key}:\n")
            for item in seq:
                first = True
                for k2, v2 in item.items():
                    prefix = f"{indent}   - " if first else f"{indent}     "
                    sub = io.StringIO()
                    _emit_value(sub, k2, v2, 0)
                    text = sub.getvalue()
                    text = prefix + text[:-1].replace("\n", "\n" + indent + "     ") + "\n"
                    buf.write(text)
                    first = False
        elif seq and isinstance(seq[0], (list, tuple)):
            items = ["[ " + ", ".join(_fmt_scalar(x) for x in it) + " ]" for it in seq]
            buf.write(f"{indent}{key}: {_wrap_flow(items, indent + '   ')}\n")
        else:
            items = [_fmt_scalar(x) for x in seq]
            buf.write(f"{indent}{key}: {_wrap_flow(items, indent + '   ')}\n")
    else:
        buf.write(f"{indent}{key}: {_fmt_scalar(v)}\n")


def dumps(doc: dict[str, Any]) -> str:
    buf = io.StringIO()
    buf.write("%YAML:1.0\n---\n")
    for k, v in doc.items():
        _emit_value(buf, k, v, 0)
    return buf.getvalue()


def dump(doc: dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(doc))
