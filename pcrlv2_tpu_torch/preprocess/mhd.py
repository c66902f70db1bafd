"""MetaImage (.mhd/.raw) reading and isotropic resampling, without
SimpleITK (port of ``pcrlv2_tpu/preprocess/mhd.py``, NumPy and host C++
only).

The reference reads LUNA16 volumes with SimpleITK (C++ ITK) and resamples to
1mm isotropic spacing with a linear interpolator (reference
``luna_preprocess.py:322-348``).  That is the only ITK surface the pipeline
touches, so this module re-owns it directly:

* ``read_mhd`` — a MetaImage header/raw parser (MHD is a plain-text
  ``Key = Value`` header next to a binary blob; LUNA16 ships uncompressed
  MET_SHORT, compressed ``.zraw`` is handled via zlib).
* ``resample_isotropic`` — axis-separable linear resampling on the physical
  grid with SimpleITK's semantics: output size ``round(in_size·in_spacing)``,
  output voxel ``i`` sampled at input continuous index ``i·out_sp/in_sp``
  (identity direction, same origin): three vectorized 1-D lerps.
* ``load_volume_1mm`` — the fused native resampler
  (``csrc/pcrl_resample.cpp``) when the library loads, else the NumPy path.

Arrays are returned in (z, y, x) index order like ``sitk.GetArrayFromImage``;
callers transpose to (x, y, z) as the reference does
(``luna_preprocess.py:290``).
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

_MET_DTYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}


@dataclass
class MetaImage:
    """A loaded MetaImage: voxel array in (z, y, x) order + geometry."""

    array: np.ndarray                      # (z, y, x)
    spacing: List[float]                   # (x, y, z) — ITK order
    origin: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    header: Dict[str, str] = field(default_factory=dict)

    @property
    def size(self) -> List[int]:
        """(x, y, z) size, ITK convention."""
        return list(self.array.shape[::-1])


def _parse_header(path: str) -> Dict[str, str]:
    header: Dict[str, str] = {}
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("ascii", errors="replace").strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            header[key.strip()] = value.strip()
            if key.strip() == "ElementDataFile":
                break  # header ends at the data-file pointer
    return header


def read_mhd(path: str) -> MetaImage:
    """Parse a ``.mhd`` header and load its raw volume."""
    header = _parse_header(path)
    ndims = int(header.get("NDims", "3"))
    dim_size = [int(v) for v in header["DimSize"].split()]
    if len(dim_size) != ndims:
        raise ValueError(f"DimSize {dim_size} does not match NDims {ndims}")
    dtype = _MET_DTYPES[header.get("ElementType", "MET_SHORT")]
    spacing = [float(v) for v in header.get(
        "ElementSpacing", header.get("ElementSize", "1 1 1")).split()]
    origin = [float(v) for v in header.get(
        "Offset", header.get("Position", "0 0 0")).split()]

    data_file = header["ElementDataFile"]
    if data_file.upper() == "LOCAL":
        raise ValueError("inline MHD data not supported (LUNA16 uses .raw)")
    if not os.path.isabs(data_file):
        data_file = os.path.join(os.path.dirname(path), data_file)

    with open(data_file, "rb") as f:
        blob = f.read()
    if header.get("CompressedData", "False").lower() == "true":
        blob = zlib.decompress(blob)

    count = int(np.prod(dim_size))
    arr = np.frombuffer(blob, dtype=dtype, count=count)
    if header.get("ElementByteOrderMSB", "False").lower() == "true" or \
            header.get("BinaryDataByteOrderMSB", "False").lower() == "true":
        arr = arr.byteswap()
    # MHD stores x-fastest; numpy reshape to (z, y, x) mirrors
    # sitk.GetArrayFromImage.
    arr = arr.reshape(dim_size[::-1])
    return MetaImage(array=arr, spacing=spacing, origin=origin, header=header)


def _lerp_axis(arr: np.ndarray, axis: int, coords: np.ndarray) -> np.ndarray:
    """Linear interpolation of ``arr`` along ``axis`` at continuous indices
    ``coords`` (clamped to the valid range — matches ITK's behavior for the
    sub-voxel overshoot its size rounding can produce)."""
    n = arr.shape[axis]
    coords = np.clip(coords, 0.0, n - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    frac = (coords - lo).astype(np.float32)
    a = np.take(arr, lo, axis=axis)
    b = np.take(arr, hi, axis=axis)
    shape = [1] * arr.ndim
    shape[axis] = len(coords)
    frac = frac.reshape(shape)
    return a + (b - a) * frac


def _resample_plan(img: MetaImage, out_spacing):
    """(out_size, scales) per (z, y, x) axis — the single source of truth for
    the SimpleITK sampling convention, shared by the NumPy path and the
    native kernel so they can never diverge: output size
    ``int(in_size·in_sp/out_sp + 0.5)``, output voxel ``i`` sampled at input
    continuous index ``i·out_sp/in_sp``."""
    in_sp = img.spacing[::-1]        # (z, y, x)
    out_sp = list(out_spacing)[::-1]
    out_size = [int(img.array.shape[d] * in_sp[d] / out_sp[d] + 0.5)
                for d in range(3)]
    scales = [out_sp[d] / in_sp[d] for d in range(3)]
    return out_size, scales


def resample_isotropic(img: MetaImage, out_spacing=(1.0, 1.0, 1.0)) -> MetaImage:
    """Resample to ``out_spacing`` with SimpleITK's linear-resampler semantics
    (reference ``luna_preprocess.py:322-348``; sampling convention in
    ``_resample_plan`` — identity transform, shared origin, axis-aligned
    direction, true for every LUNA16 volume)."""
    arr = img.array.astype(np.float32)  # (z, y, x)
    in_sp = img.spacing[::-1]
    out_sp = list(out_spacing)[::-1]
    out_size, _ = _resample_plan(img, out_spacing)
    for axis in range(3):
        if abs(in_sp[axis] - out_sp[axis]) < 1e-12 and \
                out_size[axis] == arr.shape[axis]:
            continue
        coords = np.arange(out_size[axis], dtype=np.float64) \
            * (out_sp[axis] / in_sp[axis])
        arr = _lerp_axis(arr, axis, coords)
    return MetaImage(array=arr, spacing=list(out_spacing),
                     origin=list(img.origin), header=dict(img.header))


def load_volume_1mm(path: str) -> np.ndarray:
    """Read + resample + transpose to (x, y, z) — the reference's full load
    path (``luna_preprocess.py:288-290``).

    Uses the native C++ fused resample+transpose kernel
    (``csrc/pcrl_resample.cpp`` — the SimpleITK-replacement) when the
    library builds; NumPy separable path otherwise (same sampling semantics).
    """
    img = read_mhd(path)
    out_spacing = (1.0, 1.0, 1.0)
    if img.array.dtype in (np.int16, np.float32):
        from pcrlv2_tpu_torch import native

        out_size, scales = _resample_plan(img, out_spacing)
        out = native.resample_to_xyz(img.array, scales, out_size)
        if out is not None:
            return out
    img = resample_isotropic(img, out_spacing)
    return np.ascontiguousarray(img.array.transpose(2, 1, 0))
