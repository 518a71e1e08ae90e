"""Read a ``.safetensors`` file with numpy alone: an 8-byte little-endian
header length, a JSON header of {name: {dtype, shape, data_offsets}}, then
the raw little-endian buffers. bfloat16 tensors come back as float32."""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors(path: Path) -> Dict[str, np.ndarray]:
    """{name: array} from a safetensors file; raises ValueError on a file
    whose header or offsets do not fit it."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if n > len(data) - 8:
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(data[8 : 8 + n])
    body = memoryview(data)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not 0 <= start <= end <= len(body):
            raise ValueError(f"{path}: tensor {name!r} offsets {start}:{end} outside the data")
        buf = body[start:end]
        if info["dtype"] == "BF16":
            arr = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _DTYPES:
            arr = np.frombuffer(buf, np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: tensor {name!r} holds {arr.size} values for shape {shape}")
        out[name] = arr.reshape(shape).copy()
    return out
