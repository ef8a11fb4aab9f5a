"""Self-contained NIfTI-1 codec (no nibabel dependency).

Supports .nii and .nii.gz, the dtypes used in medical imaging, sform/qform
affines, and scl_slope/scl_inter scaling — everything the reference obtains
from nibabel (load → get_fdata + affine; save with affine).

NIfTI-1 spec: 348-byte header, little- or big-endian, magic "n+1\\0"
(single file) with vox_offset to data.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


class NiftiHeader:
    """Minimal header carrying what the pipeline needs."""

    def __init__(
        self,
        shape: Tuple[int, ...],
        dtype: np.dtype,
        affine: np.ndarray,
        zooms: Tuple[float, ...],
        scl_slope: float = 1.0,
        scl_inter: float = 0.0,
    ):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.affine = np.asarray(affine, dtype=np.float64)
        self.zooms = tuple(float(z) for z in zooms)
        self.scl_slope = scl_slope
        self.scl_inter = scl_inter

    def get_zooms(self) -> Tuple[float, ...]:
        return self.zooms

    def get_best_affine(self) -> np.ndarray:
        return self.affine


class NiftiImage:
    """nibabel-like facade: ``.get_fdata()``, ``.affine``, ``.header``."""

    def __init__(self, dataobj: np.ndarray, affine: np.ndarray, header: Optional[NiftiHeader] = None):
        self.dataobj = np.asarray(dataobj)
        self.affine = np.asarray(affine, dtype=np.float64)
        if header is None:
            zooms = tuple(float(np.linalg.norm(self.affine[:3, i])) for i in range(3))
            header = NiftiHeader(self.dataobj.shape, self.dataobj.dtype, self.affine, zooms)
        self.header = header

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        data = self.dataobj.astype(dtype)
        slope, inter = self.header.scl_slope, self.header.scl_inter
        if slope not in (0.0, 1.0) or inter != 0.0:
            slope = slope if slope != 0.0 else 1.0
            data = data * slope + inter
        return data


def _open_maybe_gzip(path, mode: str):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode)
    return open(p, mode)


def _quaternion_affine(hdr_fields, zooms) -> np.ndarray:
    """Build affine from the qform quaternion (method 2 of the spec)."""
    b, c, d = hdr_fields["quatern_b"], hdr_fields["quatern_c"], hdr_fields["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = hdr_fields.get("qfac", 1.0) or 1.0
    S = np.diag([zooms[0], zooms[1], qfac * zooms[2]])
    aff = np.eye(4)
    aff[:3, :3] = R @ S
    aff[:3, 3] = [hdr_fields["qoffset_x"], hdr_fields["qoffset_y"], hdr_fields["qoffset_z"]]
    return aff


def load(path) -> NiftiImage:
    """Load a .nii / .nii.gz file.

    Malformed input raises ValueError — never a silently short or
    garbage array (truncated header/payload, bad magic, dim[0] outside
    1..7, non-positive dims or spatial pixdims; the robustness the
    reference inherits from nibabel, src/utils/io.py:54-109 of the reference).
    """
    try:
        with _open_maybe_gzip(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        raise  # serving maps this to HTTP 400 (server.py:61)
    except (OSError, EOFError) as e:  # gzip.BadGzipFile is an OSError
        raise ValueError(f"{path}: not a readable NIfTI file ({e})") from None

    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: too small to be NIfTI")

    # Detect endianness via sizeof_hdr
    for endian in ("<", ">"):
        (sizeof_hdr,) = struct.unpack(endian + "i", raw[0:4])
        if sizeof_hdr == 348:
            break
    else:
        raise ValueError(f"{path}: bad sizeof_hdr, not NIfTI-1")

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    dim = u("8h", 40)
    if not 1 <= dim[0] <= 7:
        raise ValueError(f"{path}: dim[0]={dim[0]} outside the spec's 1..7")
    ndim = dim[0]
    shape = tuple(int(x) for x in dim[1 : 1 + ndim])
    if any(s <= 0 for s in shape):
        raise ValueError(f"{path}: non-positive dimension in {shape}")
    (datatype,) = u("h", 70)
    (bitpix,) = u("h", 72)
    pixdim = u("8f", 76)
    (vox_offset,) = u("f", 108)
    (scl_slope,) = u("f", 112)
    (scl_inter,) = u("f", 116)
    (qform_code,) = u("h", 252)
    (sform_code,) = u("h", 254)
    quatern = u("6f", 256)
    srow_x = u("4f", 280)
    srow_y = u("4f", 296)
    srow_z = u("4f", 312)
    magic = raw[344:348]

    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    zooms = tuple(abs(float(z)) for z in pixdim[1 : 1 + max(3, ndim)][:3]) or (1.0, 1.0, 1.0)

    if sform_code > 0:
        affine = np.eye(4)
        affine[0], affine[1], affine[2] = srow_x, srow_y, srow_z
    elif qform_code > 0:
        affine = _quaternion_affine(
            {
                "quatern_b": quatern[0],
                "quatern_c": quatern[1],
                "quatern_d": quatern[2],
                "qoffset_x": quatern[3],
                "qoffset_y": quatern[4],
                "qoffset_z": quatern[5],
                "qfac": float(pixdim[0]) if pixdim[0] != 0 else 1.0,
            },
            zooms,
        )
    else:
        affine = np.diag(list(zooms[:3]) + [1.0])

    # spec: spatial pixdims are positive (pixdim[0]=qfac carries the sign)
    if ndim >= 2 and any(
        z <= 0.0 for z in pixdim[1 : 1 + min(3, ndim)]
    ):
        raise ValueError(
            f"{path}: non-positive spatial pixdim {pixdim[1:4]}"
        )

    offset = int(vox_offset) if vox_offset >= HEADER_SIZE else HEADER_SIZE + 4
    count = int(np.prod(shape))
    need = offset + count * dtype.itemsize
    if len(raw) < need:
        raise ValueError(
            f"{path}: truncated NIfTI payload — {len(raw)} bytes, "
            f"need {need} for shape {shape} at vox_offset {offset}"
        )
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")

    # nifti1.h: "If scl_slope = 0, the scaling is to be ignored" — BOTH
    # slope and intercept (found by the spec-built golden fixture; keeping
    # the intercept would offset every voxel of such files)
    if scl_slope == 0.0:
        scl_slope, scl_inter = 1.0, 0.0
    header = NiftiHeader(shape, dtype, affine, zooms, scl_slope, scl_inter)
    return NiftiImage(data, affine, header)


def save(img_or_array, path, affine: Optional[np.ndarray] = None) -> None:
    """Save an array (or NiftiImage) as .nii / .nii.gz."""
    if isinstance(img_or_array, NiftiImage):
        data = img_or_array.dataobj
        affine = img_or_array.affine if affine is None else affine
    else:
        data = np.asarray(img_or_array)
        affine = np.eye(4) if affine is None else np.asarray(affine, dtype=np.float64)

    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _CODES:
        data = data.astype(np.float32)
    datatype = _CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    zooms = [float(np.linalg.norm(affine[:3, i])) for i in range(min(3, ndim))]
    zooms += [1.0] * (7 - len(zooms))
    pixdim = [1.0] + zooms  # pixdim[0]=qfac

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = NIFTI_XFORM_SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + np.asfortranarray(data).tobytes(order="F")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with _open_maybe_gzip(path, "wb") as f:
        f.write(payload)


class Nifti1Image(NiftiImage):
    """Constructor-compatible alias (nibabel.Nifti1Image(data, affine))."""
