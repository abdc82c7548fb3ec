"""Self-contained EXIF metadata reader/writer (no piexif dependency).

The counterpart of :mod:`glimpse_tpu.exif`: parse camera metadata (image
size, capture time with subseconds, exposure, aperture, ISO, focal length,
make/model) from JPEG/TIFF files, look up sensor sizes for known cameras,
and write edited tags back into JPEG files. The TIFF/EXIF structure codec
below is implemented from the EXIF 2.3 specification.
"""
import copy
import datetime as datetime_module
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

# Sensor sizes (mm) for known camera make/model strings, from public
# manufacturer specifications.
SENSOR_SIZES = {
    "NIKON CORPORATION NIKON D2X": (23.7, 15.7),
    "NIKON CORPORATION NIKON D200": (23.6, 15.8),
    "NIKON CORPORATION NIKON D300S": (23.6, 15.8),
    "NIKON E8700": (8.8, 6.6),
    "Canon Canon EOS 20D": (22.5, 15.0),
    "Canon Canon EOS 40D": (22.2, 14.8),
}

# EXIF value types: (struct format char, size in bytes)
_TYPES = {
    1: ("B", 1),   # BYTE
    2: (None, 1),  # ASCII
    3: ("H", 2),   # SHORT
    4: ("L", 4),   # LONG
    5: (None, 8),  # RATIONAL
    6: ("b", 1),   # SBYTE
    7: (None, 1),  # UNDEFINED
    8: ("h", 2),   # SSHORT
    9: ("l", 4),   # SLONG
    10: (None, 8),  # SRATIONAL
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
}

# Tag code -> name, per IFD group. Codes from the EXIF 2.3 tag tables.
TAG_NAMES = {
    "0th": {
        0x010E: "ImageDescription", 0x010F: "Make", 0x0110: "Model",
        0x0112: "Orientation", 0x011A: "XResolution", 0x011B: "YResolution",
        0x0128: "ResolutionUnit", 0x0131: "Software", 0x0132: "DateTime",
        0x013B: "Artist", 0x8298: "Copyright",
        0x8769: "ExifTag", 0x8825: "GPSTag",
        0x0100: "ImageWidth", 0x0101: "ImageLength",
    },
    "Exif": {
        0x829A: "ExposureTime", 0x829D: "FNumber", 0x8822: "ExposureProgram",
        0x8827: "ISOSpeedRatings", 0x9000: "ExifVersion",
        0x9003: "DateTimeOriginal", 0x9004: "DateTimeDigitized",
        0x9101: "ComponentsConfiguration", 0x9102: "CompressedBitsPerPixel",
        0x9201: "ShutterSpeedValue", 0x9202: "ApertureValue",
        0x9203: "BrightnessValue", 0x9204: "ExposureBiasValue",
        0x9205: "MaxApertureValue", 0x9206: "SubjectDistance",
        0x9207: "MeteringMode", 0x9208: "LightSource", 0x9209: "Flash",
        0x920A: "FocalLength", 0x927C: "MakerNote", 0x9286: "UserComment",
        0x9290: "SubSecTime", 0x9291: "SubSecTimeOriginal",
        0x9292: "SubSecTimeDigitized", 0xA000: "FlashpixVersion",
        0xA001: "ColorSpace", 0xA002: "PixelXDimension",
        0xA003: "PixelYDimension", 0xA005: "InteroperabilityTag",
        0xA20E: "FocalPlaneXResolution", 0xA20F: "FocalPlaneYResolution",
        0xA210: "FocalPlaneResolutionUnit", 0xA217: "SensingMethod",
        0xA300: "FileSource", 0xA301: "SceneType", 0xA302: "CFAPattern",
        0xA401: "CustomRendered", 0xA402: "ExposureMode",
        0xA403: "WhiteBalance", 0xA404: "DigitalZoomRatio",
        0xA405: "FocalLengthIn35mmFilm", 0xA406: "SceneCaptureType",
        0xA407: "GainControl", 0xA408: "Contrast", 0xA409: "Saturation",
        0xA40A: "Sharpness", 0xA40C: "SubjectDistanceRange",
    },
    "GPS": {
        0x0000: "GPSVersionID", 0x0001: "GPSLatitudeRef", 0x0002: "GPSLatitude",
        0x0003: "GPSLongitudeRef", 0x0004: "GPSLongitude",
        0x0005: "GPSAltitudeRef", 0x0006: "GPSAltitude",
        0x0007: "GPSTimeStamp", 0x001D: "GPSDateStamp",
    },
    "Interop": {0x0001: "InteroperabilityIndex", 0x0002: "InteroperabilityVersion"},
}
TAG_NAMES["1st"] = dict(TAG_NAMES["0th"])
TAG_NAMES["1st"].update({0x0201: "JPEGInterchangeFormat",
                         0x0202: "JPEGInterchangeFormatLength"})
TAG_CODES = {
    group: {name: code for code, name in names.items()}
    for group, names in TAG_NAMES.items()
}
# Tag code -> EXIF type used when writing (only for tags we re-encode).
_WRITE_TYPES = {
    "0th": {0x010F: 2, 0x0110: 2, 0x0131: 2, 0x0132: 2, 0x8769: 4, 0x8825: 4,
            0x0112: 3, 0x011A: 5, 0x011B: 5, 0x0128: 3},
    "Exif": {0x829A: 5, 0x829D: 5, 0x8827: 3, 0x9003: 2, 0x9004: 2,
             0x9291: 2, 0x9290: 2, 0x9292: 2, 0x920A: 5, 0xA002: 4,
             0xA003: 4, 0x9000: 7, 0xA000: 7, 0xA001: 3, 0xA405: 3},
    "GPS": {},
    "Interop": {0x0001: 2},
    "1st": {},
}


class _TiffReader:
    def __init__(self, data: bytes):
        self.data = data
        if data[0:2] == b"II":
            self.e = "<"
        elif data[0:2] == b"MM":
            self.e = ">"
        else:
            raise ValueError("Not a TIFF header")
        magic, self.first_ifd = struct.unpack(self.e + "HL", data[2:8])
        if magic != 42:
            raise ValueError("Bad TIFF magic")

    def u16(self, off):
        return struct.unpack_from(self.e + "H", self.data, off)[0]

    def u32(self, off):
        return struct.unpack_from(self.e + "L", self.data, off)[0]

    def read_ifd(self, offset) -> Tuple[Dict[int, Any], int]:
        """Parse one IFD; returns ({code: value}, next_ifd_offset)."""
        entries = {}
        try:
            n = self.u16(offset)
        except struct.error:
            return entries, 0
        for i in range(n):
            base = offset + 2 + 12 * i
            try:
                code = self.u16(base)
                typ = self.u16(base + 2)
                count = self.u32(base + 4)
            except struct.error:
                break
            if typ not in _TYPES:
                continue
            fmt, unit = _TYPES[typ]
            nbytes = unit * count
            if nbytes <= 4:
                voff = base + 8
            else:
                voff = self.u32(base + 8)
            raw = self.data[voff : voff + nbytes]
            if len(raw) < nbytes:
                continue
            entries[code] = self._decode(typ, count, raw)
        next_off = self.u32(offset + 2 + 12 * n) if len(self.data) >= offset + 6 + 12 * n else 0
        return entries, next_off

    def _decode(self, typ, count, raw):
        fmt, unit = _TYPES[typ]
        if typ == 2:  # ASCII: strip trailing NUL
            return raw.rstrip(b"\x00")
        if typ == 7:
            return raw
        if typ in (5, 10):
            kind = "LL" if typ == 5 else "ll"
            vals = [
                struct.unpack_from(self.e + kind, raw, 8 * i) for i in range(count)
            ]
            vals = [tuple(v) for v in vals]
            return vals[0] if count == 1 else tuple(vals)
        vals = struct.unpack(self.e + fmt * count, raw)
        return vals[0] if count == 1 else vals


def _read_exif_blob(path: Union[str, Path]) -> Optional[bytes]:
    """Extract the TIFF-structured EXIF payload from a JPEG or TIFF file."""
    with open(str(path), "rb") as fp:
        head = fp.read(2)
        if head == b"\xff\xd8":  # JPEG
            while True:
                marker = fp.read(2)
                if len(marker) < 2 or marker[0] != 0xFF:
                    return None
                if marker[1] in (0xD8, 0x01) or 0xD0 <= marker[1] <= 0xD7:
                    continue
                size = struct.unpack(">H", fp.read(2))[0]
                body = fp.read(size - 2)
                if marker[1] == 0xE1 and body[0:6] == b"Exif\x00\x00":
                    return body[6:]
                if marker[1] == 0xDA:  # start of scan: no EXIF
                    return None
        elif head in (b"II", b"MM"):  # TIFF: whole file is the structure
            fp.seek(0)
            return fp.read()
    return None


def _parse_tags(blob: bytes) -> Dict[str, Dict[str, Any]]:
    r = _TiffReader(blob)
    ifd0, next_ifd = r.read_ifd(r.first_ifd)
    groups: Dict[str, Dict[int, Any]] = {"0th": ifd0, "Exif": {}, "GPS": {},
                                         "Interop": {}, "1st": {}}
    if 0x8769 in ifd0:
        groups["Exif"], _ = r.read_ifd(ifd0[0x8769])
    if 0x8825 in ifd0:
        groups["GPS"], _ = r.read_ifd(ifd0[0x8825])
    if 0xA005 in groups["Exif"]:
        groups["Interop"], _ = r.read_ifd(groups["Exif"][0xA005])
    thumbnail = None
    if next_ifd:
        groups["1st"], _ = r.read_ifd(next_ifd)
        fmt = groups["1st"].get(0x0201)
        length = groups["1st"].get(0x0202)
        if fmt and length:
            thumbnail = blob[fmt : fmt + length]
    named: Dict[str, Dict[str, Any]] = {}
    for group, entries in groups.items():
        named[group] = {}
        for code, value in entries.items():
            name = TAG_NAMES.get(group, {}).get(code, code)
            if name in ("ExifTag", "GPSTag", "InteroperabilityTag"):
                continue
            named[group][name] = value
    if thumbnail is not None:
        named["thumbnail"] = thumbnail
    return named


class _TiffWriter:
    """Serialize named tag groups back into a TIFF-structured EXIF blob."""

    def __init__(self, tags: Dict[str, Dict[str, Any]]):
        self.tags = tags

    def _encode_value(self, group: str, code: int, value: Any) -> Tuple[int, int, bytes]:
        """Return (type, count, payload bytes) for one tag value."""
        typ = _WRITE_TYPES.get(group, {}).get(code)
        if isinstance(value, bytes) and typ != 2:
            typ = typ or 7
            return typ, len(value), value
        if typ == 2 or isinstance(value, (str, bytes)):
            raw = value if isinstance(value, bytes) else str(value).encode()
            raw += b"\x00"
            return 2, len(raw), raw
        if isinstance(value, tuple) and len(value) == 2 and all(
            isinstance(v, int) for v in value
        ) and (typ == 5 or typ is None):
            if min(value) < 0:
                return 10, 1, struct.pack("<ll", *value)
            return 5, 1, struct.pack("<LL", *value)
        if isinstance(value, tuple) and value and isinstance(value[0], tuple):
            if any(min(v) < 0 for v in value):
                raw = b"".join(struct.pack("<ll", *v) for v in value)
                return 10, len(value), raw
            raw = b"".join(struct.pack("<LL", *v) for v in value)
            return 5, len(value), raw
        if isinstance(value, float):
            # Encode floats as rationals with 1e6 denominator.
            return 5, 1, struct.pack("<LL", int(round(value * 1e6)), 1000000)
        if isinstance(value, int):
            if typ == 3:
                return 3, 1, struct.pack("<H", value)
            return 4, 1, struct.pack("<L", value)
        if isinstance(value, tuple):
            if typ == 3 or all(0 <= v < 65536 for v in value):
                return 3, len(value), struct.pack("<" + "H" * len(value), *value)
            return 4, len(value), struct.pack("<" + "L" * len(value), *value)
        raise ValueError(f"Cannot encode tag value: {value!r}")

    def _build_ifd(self, group: str, extra: Dict[int, Any], data_start: int):
        """Build one IFD. Returns (entry_block, data_block) with data offsets
        relative to the TIFF origin starting at data_start."""
        entries = {}
        for name, value in self.tags.get(group, {}).items():
            if isinstance(name, str):
                code = TAG_CODES.get(group, {}).get(name)
                if code is None:
                    raise ValueError(f"Invalid tag '{name}' in group '{group}'")
            else:
                code = int(name)
            entries[code] = value
        entries.update(extra)
        codes = sorted(entries)
        entry_block = struct.pack("<H", len(codes))
        data_block = b""
        for code in codes:
            if code in (0x8769, 0x8825, 0xA005) and isinstance(entries[code], int):
                typ, count, raw = 4, 1, struct.pack("<L", entries[code])
            else:
                typ, count, raw = self._encode_value(group, code, entries[code])
            if len(raw) <= 4:
                payload = raw + b"\x00" * (4 - len(raw))
                entry_block += struct.pack("<HHL", code, typ, count) + payload
            else:
                entry_block += struct.pack(
                    "<HHLL", code, typ, count, data_start + len(data_block)
                )
                data_block += raw + (b"\x00" if len(raw) % 2 else b"")
        return entry_block, data_block

    def dump(self) -> bytes:
        header_size = 8
        groups = ["0th", "Exif", "GPS", "Interop"]
        present = {
            g: g in self.tags and (self.tags[g] or g == "0th") for g in groups
        }
        # Iteratively fix point the layout (offsets depend on sizes).
        pointers: Dict[str, int] = {}
        for _ in range(4):
            blobs = {}
            offset = header_size
            order = [g for g in groups if present.get(g)]
            # First pass with current pointer guesses to get sizes.
            tentative = {}
            for g in order:
                extra = {}
                if g == "0th":
                    if present.get("Exif"):
                        extra[0x8769] = pointers.get("Exif", 0)
                    if present.get("GPS"):
                        extra[0x8825] = pointers.get("GPS", 0)
                elif g == "Exif" and present.get("Interop"):
                    extra[0xA005] = pointers.get("Interop", 0)
                # next-IFD pointer after entries (always 0: no thumbnail IFD)
                entry, data = self._build_ifd(g, extra, 0)
                tentative[g] = (entry, data)
            new_pointers = {}
            offset = header_size
            layout = {}
            for g in order:
                entry, data = tentative[g]
                ifd_size = len(entry) + 4  # + next-IFD pointer
                new_pointers[g] = offset
                layout[g] = (offset, ifd_size)
                offset += ifd_size + len(data)
            if new_pointers == pointers:
                break
            pointers = new_pointers
        # Final serialization with correct data offsets.
        out = b"II*\x00" + struct.pack("<L", pointers.get("0th", 8))
        for g in [g for g in groups if present.get(g)]:
            extra = {}
            if g == "0th":
                if present.get("Exif"):
                    extra[0x8769] = pointers["Exif"]
                if present.get("GPS"):
                    extra[0x8825] = pointers["GPS"]
            elif g == "Exif" and present.get("Interop"):
                extra[0xA005] = pointers["Interop"]
            ifd_offset, ifd_size = layout[g]
            entry, data = self._build_ifd(g, extra, ifd_offset + ifd_size)
            out += entry + struct.pack("<L", 0) + data
        return out


class Exif:
    """Parsed EXIF metadata of an image file.

    Attributes:
        tags: Tag values grouped by IFD ('0th', 'Exif', 'GPS', 'Interop',
            '1st', plus 'thumbnail' bytes when retained).
    """

    def __init__(self, path: Union[str, Path] = None, thumbnail: bool = False) -> None:
        if path is None:
            self.tags = {}
            return
        blob = _read_exif_blob(path)
        self.tags = _parse_tags(blob) if blob else {}
        if not thumbnail:
            self.tags.pop("thumbnail", None)
            self.tags.pop("1st", None)

    # ---- Parsed properties ---- #

    @property
    def imgsz(self) -> Optional[Tuple[int, int]]:
        """Image size in pixels (nx, ny)."""
        width = self.parse_tag("PixelXDimension")
        height = self.parse_tag("PixelYDimension")
        if width and height:
            return int(width), int(height)
        return None

    @property
    def datetime(self) -> Optional[datetime_module.datetime]:
        """Capture date and time (with subseconds when available)."""
        stamp = self.parse_tag("DateTimeOriginal")
        if not stamp:
            return None
        text, layout = str(stamp), "%Y:%m:%d %H:%M:%S"
        subseconds = self.parse_tag("SubSecTimeOriginal")
        if subseconds:
            text += f".{subseconds}"
            layout += ".%f"
        return datetime_module.datetime.strptime(text, layout)

    @property
    def exposure(self) -> Optional[float]:
        """Exposure time in seconds."""
        value = self.parse_tag("ExposureTime")
        return float(value) if value else None

    @property
    def aperture(self) -> Optional[float]:
        """Aperture as the f-number."""
        value = self.parse_tag("FNumber")
        return float(value) if value else None

    @property
    def iso(self) -> Optional[int]:
        """ISO film speed."""
        value = self.parse_tag("ISOSpeedRatings")
        return int(value) if value else None

    @property
    def fmm(self) -> Optional[float]:
        """Focal length in millimeters."""
        value = self.parse_tag("FocalLength")
        return float(value) if value else None

    @property
    def make(self) -> Optional[str]:
        """Camera make."""
        value = self.parse_tag("Make", group="0th")
        return str(value) if value else None

    @property
    def model(self) -> Optional[str]:
        """Camera model."""
        value = self.parse_tag("Model", group="0th")
        return str(value) if value else None

    @property
    def sensorsz(self) -> Optional[Tuple[float, float]]:
        """Sensor size in millimeters, looked up from make and model."""
        if self.make and self.model:
            return SENSOR_SIZES.get(self.make.strip() + " " + self.model.strip())
        return None

    def parse_tag(self, tag: str, group: str = "Exif") -> Any:
        """Return a tag value parsed to a native type (str, float, int)."""
        value = self.tags.get(group, {}).get(tag)
        if isinstance(value, bytes):
            return value.decode(errors="replace")
        is_rational = (
            isinstance(value, tuple)
            and len(value) == 2
            and all(isinstance(part, int) for part in value)
        )
        if is_rational:
            numerator, denominator = value
            return numerator / denominator
        return value

    # ---- Writing ---- #

    def dump(self) -> bytes:
        """Serialize :attr:`tags` to a JPEG APP1 EXIF payload."""
        for group in self.tags:
            if group == "thumbnail":
                continue
            if group not in ("0th", "1st", "Exif", "GPS", "Interop"):
                raise ValueError(f"Invalid group '{group}'")
            for tag in self.tags[group]:
                if isinstance(tag, str) and tag not in TAG_CODES.get(group, {}):
                    raise ValueError(f"Invalid tag '{tag}' in group '{group}'")
        tags = copy.deepcopy(self.tags)
        tags.pop("1st", None)
        tags.pop("thumbnail", None)
        tags.setdefault("0th", {})
        return b"Exif\x00\x00" + _TiffWriter(tags).dump()

    def insert(self, path: Union[str, Path]) -> None:
        """Insert :attr:`tags` into a JPEG file, replacing existing EXIF."""
        payload = self.dump()
        path = str(path)
        with open(path, "rb") as fp:
            data = fp.read()
        if data[0:2] != b"\xff\xd8":
            raise ValueError("Can only insert EXIF into JPEG files")
        # Walk segments, dropping existing EXIF APP1s; insert after SOI/APP0.
        out = [data[0:2]]
        pos = 2
        inserted = False
        app1 = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
        while pos < len(data) - 1:
            if data[pos] != 0xFF:
                break
            marker = data[pos + 1]
            if marker == 0xDA:  # start of scan: insert before if needed
                break
            size = struct.unpack(">H", data[pos + 2 : pos + 4])[0]
            segment = data[pos : pos + 2 + size]
            if marker == 0xE1 and segment[4:10] == b"Exif\x00\x00":
                if not inserted:
                    out.append(app1)
                    inserted = True
                # drop old EXIF
            elif marker == 0xE0 and not inserted:
                out.append(segment)
                out.append(app1)
                inserted = True
            else:
                out.append(segment)
            pos += 2 + size
        if not inserted:
            out.append(app1)
        out.append(data[pos:])
        with open(path, "wb") as fp:
            fp.write(b"".join(out))
