"""Minimal self-contained DICOM codec (no pydicom); a copy of the JAX
package's ``preprocessing/dicom.py``.

Reads uncompressed DICOM Part 10 files — explicit & implicit VR little
endian — covering the tag set the preprocessing pipeline needs
(geometry, rescale, PET radiopharmaceutical sequence, patient info,
pixel data). Also writes explicit-VR-LE files for test fixtures.

Returned datasets expose pydicom-style attribute names
(``ds.InstanceNumber``, ``ds.pixel_array``, …) so the converter code reads
naturally against the reference's behavior (dicom_converter.py:91-284).

Out of scope (clean ValueError, never a silent misread): compressed
transfer syntaxes and big-endian explicit VR (1.2.840.10008.1.2.2 —
retired 2006; present only in old archives, reject rather than risk a
byte-swapped volume). Multi-frame files decode via NumberOfFrames.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

# (group, element) → attribute name; VR given for the writer.
TAGS: Dict[Tuple[int, int], Tuple[str, str]] = {
    (0x0002, 0x0010): ("TransferSyntaxUID", "UI"),
    (0x0008, 0x0020): ("StudyDate", "DA"),
    (0x0008, 0x0031): ("SeriesTime", "TM"),
    (0x0008, 0x0032): ("AcquisitionTime", "TM"),
    (0x0008, 0x0060): ("Modality", "CS"),
    (0x0008, 0x0070): ("Manufacturer", "LO"),
    (0x0008, 0x0080): ("InstitutionName", "LO"),
    (0x0010, 0x0010): ("PatientName", "PN"),
    (0x0010, 0x0020): ("PatientID", "LO"),
    (0x0010, 0x0040): ("PatientSex", "CS"),
    (0x0010, 0x1010): ("PatientAge", "AS"),
    (0x0010, 0x1020): ("PatientSize", "DS"),
    (0x0010, 0x1030): ("PatientWeight", "DS"),
    (0x0018, 0x0050): ("SliceThickness", "DS"),
    (0x0018, 0x1072): ("RadiopharmaceuticalStartTime", "TM"),
    (0x0018, 0x1074): ("RadionuclideTotalDose", "DS"),
    (0x0018, 0x1075): ("RadionuclideHalfLife", "DS"),
    (0x0018, 0x0024): ("SequenceName", "SH"),
    (0x0018, 0x0080): ("RepetitionTime", "DS"),
    (0x0018, 0x0081): ("EchoTime", "DS"),
    (0x0018, 0x0087): ("MagneticFieldStrength", "DS"),
    (0x0020, 0x0013): ("InstanceNumber", "IS"),
    (0x0020, 0x0032): ("ImagePositionPatient", "DS"),
    (0x0020, 0x0037): ("ImageOrientationPatient", "DS"),
    (0x0020, 0x1041): ("SliceLocation", "DS"),
    (0x0028, 0x0002): ("SamplesPerPixel", "US"),
    (0x0028, 0x0008): ("NumberOfFrames", "IS"),
    (0x0028, 0x0010): ("Rows", "US"),
    (0x0028, 0x0011): ("Columns", "US"),
    (0x0028, 0x0030): ("PixelSpacing", "DS"),
    (0x0028, 0x0100): ("BitsAllocated", "US"),
    (0x0028, 0x0103): ("PixelRepresentation", "US"),
    (0x0028, 0x1052): ("RescaleIntercept", "DS"),
    (0x0028, 0x1053): ("RescaleSlope", "DS"),
    (0x0054, 0x0016): ("RadiopharmaceuticalInformationSequence", "SQ"),
    (0x7FE0, 0x0010): ("PixelData", "OW"),
}
_NAME_TO_TAG = {name: (tag, vr) for tag, (name, vr) in TAGS.items()}

_EXPLICIT_LONG_VRS = {"OB", "OW", "OF", "SQ", "UT", "UN"}
_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"


class Dataset:
    """Attribute-bag dataset with lazy pixel decoding."""

    def __init__(self):
        self._raw_pixel: Optional[bytes] = None

    def __contains__(self, name: str) -> bool:
        return hasattr(self, name)

    @property
    def pixel_array(self) -> np.ndarray:
        """Decoded pixels, pydicom-shaped (dicom_converter.py:40-89 reads
        through pydicom which honors NumberOfFrames):

        - single frame:      ``[rows, cols]`` (+ ``[..., samples]`` if >1)
        - NumberOfFrames>1:  ``[frames, rows, cols]`` (+ samples axis),
          frames laid out frame-major per PS3.5 §8.2.

        The byte count is validated EXACTLY (± one PS3.5 even-length pad
        byte for 8-bit data) — a short or oversized PixelData raises
        instead of silently truncating an enhanced-CT volume to one slice.
        """
        if self._raw_pixel is None:
            raise AttributeError("no PixelData")
        bits = int(getattr(self, "BitsAllocated", 16))
        signed = int(getattr(self, "PixelRepresentation", 0)) == 1
        samples = int(getattr(self, "SamplesPerPixel", 1))
        frames = int(getattr(self, "NumberOfFrames", 1) or 1)
        rows = int(self.Rows)
        cols = int(self.Columns)
        if bits == 16:
            dtype = np.dtype(np.int16 if signed else np.uint16)
        elif bits == 8:
            dtype = np.dtype(np.int8 if signed else np.uint8)
        else:
            raise ValueError(f"unsupported BitsAllocated={bits}")
        if min(frames, rows, cols, samples) <= 0:
            raise ValueError(
                f"bad pixel geometry: frames={frames} rows={rows} "
                f"cols={cols} samples={samples}"
            )
        expected = frames * rows * cols * samples * dtype.itemsize
        pad_ok = 1 if (dtype.itemsize == 1 and expected % 2) else 0
        nbytes = len(self._raw_pixel)
        if nbytes not in (expected, expected + pad_ok):
            raise ValueError(
                f"PixelData has {nbytes} bytes, expected {expected} for "
                f"frames={frames} rows={rows} cols={cols} "
                f"samples={samples} at {bits} bits"
            )
        arr = np.frombuffer(self._raw_pixel[:expected], dtype=dtype)
        shape = [rows, cols]
        if samples > 1:
            shape.append(samples)
        if frames > 1:
            shape.insert(0, frames)
        return arr.reshape(shape)


def _parse_value(vr: str, data: bytes) -> Any:
    if vr in ("US",):
        vals = list(struct.unpack("<" + "H" * (len(data) // 2), data))
        return vals[0] if len(vals) == 1 else vals
    if vr in ("UL",):
        vals = list(struct.unpack("<" + "I" * (len(data) // 4), data))
        return vals[0] if len(vals) == 1 else vals
    if vr in ("FL",):
        vals = list(struct.unpack("<" + "f" * (len(data) // 4), data))
        return vals[0] if len(vals) == 1 else vals
    if vr in ("FD",):
        vals = list(struct.unpack("<" + "d" * (len(data) // 8), data))
        return vals[0] if len(vals) == 1 else vals
    # string types
    s = data.decode("ascii", errors="replace").rstrip("\x00 ").strip()
    if vr in ("DS", "IS"):
        parts = [p for p in s.split("\\") if p != ""]
        try:
            vals = [float(p) if vr == "DS" else int(float(p)) for p in parts]
        except ValueError:
            return s
        return vals[0] if len(vals) == 1 else vals
    if "\\" in s:
        return s.split("\\")
    return s


def _read_elements(buf: bytes, offset: int, end: int, explicit: bool, ds: Dataset) -> int:
    """Parse data elements from buf[offset:end] into ds; returns new offset."""
    while offset + 8 <= end:
        group, elem = struct.unpack_from("<HH", buf, offset)
        offset += 4
        if (group, elem) == (0xFFFE, 0xE00D) or (group, elem) == (0xFFFE, 0xE0DD):
            # item/sequence delimitation
            offset += 4  # skip zero length
            return offset
        if explicit and group != 0xFFFE:
            vr = buf[offset : offset + 2].decode("ascii", errors="replace")
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, offset + 4)
                offset += 8
            else:
                (length,) = struct.unpack_from("<H", buf, offset + 2)
                offset += 4
        else:
            (length,) = struct.unpack_from("<I", buf, offset)
            offset += 4
            name_vr = TAGS.get((group, elem))
            vr = name_vr[1] if name_vr else "UN"

        if (group, elem) == (0xFFFE, 0xE000):  # sequence item start
            # handled by sequence parser; shouldn't get here at top level
            item_end = end if length == 0xFFFFFFFF else offset + length
            offset = _read_elements(buf, offset, item_end, explicit, ds)
            continue

        name_vr = TAGS.get((group, elem))

        if vr == "SQ" or (name_vr and name_vr[1] == "SQ"):
            items: List[Dataset] = []
            seq_end = end if length == 0xFFFFFFFF else offset + length
            while offset + 8 <= seq_end:
                g2, e2 = struct.unpack_from("<HH", buf, offset)
                if (g2, e2) == (0xFFFE, 0xE0DD):  # sequence delimiter
                    offset += 8
                    break
                if (g2, e2) != (0xFFFE, 0xE000):
                    break
                (ilen,) = struct.unpack_from("<I", buf, offset + 4)
                offset += 8
                item = Dataset()
                item_end = seq_end if ilen == 0xFFFFFFFF else offset + ilen
                offset = _read_elements(buf, offset, item_end, explicit, item)
                items.append(item)
            if name_vr:
                setattr(ds, name_vr[0], items)
            continue

        if length == 0xFFFFFFFF:
            raise ValueError("undefined-length non-SQ element (compressed pixel data?)")

        if offset + length > end:
            # a declared length overrunning the buffer means a truncated
            # or corrupt file — never hand back a silently short value
            raise ValueError(
                f"element ({group:04x},{elem:04x}) of length {length} "
                f"overruns the file ({end - offset} bytes left)"
            )
        data = buf[offset : offset + length]
        offset += length

        if (group, elem) == (0x7FE0, 0x0010):
            ds._raw_pixel = data
            continue
        if name_vr:
            setattr(ds, name_vr[0], _parse_value(vr if explicit else name_vr[1], data))
    if offset != end:
        # 1..7 trailing bytes: a partial element header at EOF
        raise ValueError(
            f"{end - offset} trailing bytes after the last data element"
        )
    return offset


_PLAUSIBLE_GROUPS = frozenset(
    {0x0002, 0x0008, 0x0009, 0x0010, 0x0018, 0x0020, 0x0028, 0x0032,
     0x0054, 0x3006, 0x7FE0, 0xFFFE}
)


def dcmread(path) -> Dataset:
    """Read a DICOM Part-10 file (or raw dataset without preamble).

    Malformed input (truncated elements, lengths overrunning EOF, bytes
    that are not DICOM at all) raises ValueError — the reader never
    silently returns a partial dataset.
    """
    buf = Path(path).read_bytes()
    ds = Dataset()

    if len(buf) > 132 and buf[128:132] == b"DICM":
        # file meta group: always explicit VR LE
        offset = 132
        meta = Dataset()
        # parse meta group: read (0002,0000) length
        group, elem = struct.unpack_from("<HH", buf, offset)
        if (group, elem) == (0x0002, 0x0000):
            vr = buf[offset + 4 : offset + 6]
            (glen,) = struct.unpack_from("<H", buf, offset + 6)
            (meta_len,) = struct.unpack_from("<I", buf, offset + 8)
            offset += 12
            meta_end = offset + meta_len
            _read_elements(buf, offset, meta_end, True, meta)
            offset = meta_end
        else:
            meta_end = offset
        ts = getattr(meta, "TransferSyntaxUID", _EXPLICIT_LE)
        if ts not in (_EXPLICIT_LE, _IMPLICIT_LE):
            raise ValueError(f"unsupported transfer syntax: {ts}")
        explicit = ts == _EXPLICIT_LE
    else:
        offset = 0
        if len(buf) < 8:
            raise ValueError(f"{path}: too small to be a DICOM dataset")
        # a raw (preamble-less) dataset must start at a plausible group —
        # arbitrary bytes must not quietly parse into an empty dataset
        (group0,) = struct.unpack_from("<H", buf, 0)
        if group0 not in _PLAUSIBLE_GROUPS:
            raise ValueError(
                f"{path}: not a DICOM file (no DICM magic; first group "
                f"{group0:#06x} implausible)"
            )
        # sniff: explicit files have an uppercase-letter VR at offset 4
        vr_probe = buf[4:6]
        explicit = vr_probe.isalpha() and vr_probe.isupper()

    try:
        _read_elements(buf, offset, len(buf), explicit, ds)
    except struct.error:
        raise ValueError(f"{path}: truncated DICOM element") from None
    return ds


# ---------------------------------------------------------------------------
# writer (test fixtures / interchange)
# ---------------------------------------------------------------------------

def _encode_value(vr: str, value: Any) -> bytes:
    if vr == "US":
        vals = value if isinstance(value, (list, tuple)) else [value]
        return struct.pack("<" + "H" * len(vals), *[int(v) for v in vals])
    if vr in ("DS", "IS"):
        vals = value if isinstance(value, (list, tuple)) else [value]
        s = "\\".join(
            (f"{v:g}" if vr == "DS" else str(int(v))) for v in vals
        )
        data = s.encode("ascii")
    elif vr == "SQ":
        raise ValueError("use _encode_sequence")
    else:
        vals = value if isinstance(value, (list, tuple)) else [value]
        data = "\\".join(str(v) for v in vals).encode("ascii")
    if len(data) % 2:
        # PS3.5 §6.2: UI values pad to even length with NUL, string VRs
        # with space (caught by the spec-built golden writer test)
        data += b"\x00" if vr == "UI" else b" "
    return data


def _encode_element(tag: Tuple[int, int], vr: str, data: bytes) -> bytes:
    head = struct.pack("<HH", *tag)
    if vr in _EXPLICIT_LONG_VRS:
        return head + vr.encode() + b"\x00\x00" + struct.pack("<I", len(data)) + data
    return head + vr.encode() + struct.pack("<H", len(data)) + data


def dcmwrite(path, attrs: Dict[str, Any], pixel_array: Optional[np.ndarray] = None) -> None:
    """Write an explicit-VR-LE DICOM file from attribute dict + pixels."""
    body = b""
    elements: List[Tuple[Tuple[int, int], str, Any]] = []
    for name, value in attrs.items():
        if name not in _NAME_TO_TAG:
            raise KeyError(f"unknown DICOM attribute {name}")
        tag, vr = _NAME_TO_TAG[name]
        elements.append((tag, vr, value))
    elements.sort(key=lambda e: e[0])

    for tag, vr, value in elements:
        if vr == "SQ":
            items = b""
            for item in value:  # each item: dict of attrs
                item_body = b""
                inner = sorted(
                    ((_NAME_TO_TAG[n][0], _NAME_TO_TAG[n][1], v) for n, v in item.items()),
                    key=lambda e: e[0],
                )
                for t2, vr2, v2 in inner:
                    item_body += _encode_element(t2, vr2, _encode_value(vr2, v2))
                items += struct.pack("<HHI", 0xFFFE, 0xE000, len(item_body)) + item_body
            body += _encode_element(tag, "SQ", items)
        else:
            body += _encode_element(tag, vr, _encode_value(vr, value))

    if pixel_array is not None:
        arr = np.ascontiguousarray(pixel_array)
        body += _encode_element((0x7FE0, 0x0010), "OW", arr.tobytes())

    # file meta
    meta_body = _encode_element(
        (0x0002, 0x0010), "UI", _encode_value("UI", _EXPLICIT_LE)
    )
    meta = (
        _encode_element((0x0002, 0x0000), "UL", struct.pack("<I", len(meta_body)))
        + meta_body
    )

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)
