"""EXIF / XMP metadata: camera identity and the geotagged pose of a JPEG.

Port of ``imageanalysis_tpu/io/exif.py`` without PIL: a small host parser
walks the JPEG's markers to the APP1 segment that starts ``Exif\\0\\0``
(the first one, as PIL takes it), reads its TIFF data in either byte order
(``II`` or ``MM``) and returns the tags the reference reads:

- IFD0: Make ``0x010F``, Model ``0x0110``, DateTime ``0x0132`` and the
  pointers to the Exif IFD ``0x8769`` and the GPS IFD ``0x8825``;
- the Exif IFD: FocalLength ``0x920A``, LensModel ``0xA434``;
- the GPS IFD: tags 1–6 (latitude, longitude, altitude and their refs),

in the types BYTE, ASCII, SHORT, LONG and RATIONAL, values of 4 bytes or
fewer inline. The XMP packet is the reference's raw-bytes regex scan.

Behaviours of the reference kept on purpose:

- ``get_pose`` ignores GPSAltitudeRef: an altitude stored as negative
  (ref 1) reads back positive;
- ``unixtime`` is a naive local-time ``datetime.timestamp()``;
- the Mavic Mini 2 (``FC7303``) reads flight yaw, not gimbal yaw.

``write_geotag`` diverges from the reference on purpose: the reference
re-encodes the JPEG through PIL; here only the Exif APP1 is rewritten
(IFD0's and the Exif IFD's entries that the reader reads are kept, the
GPS IFD and DateTime replaced) and every other byte of the file, the
entropy-coded data included, stays as it was, so the pixels do not change.
"""

from __future__ import annotations

import datetime
import os
import re
import struct

from .logger import log

EXIF_HEADER = b"Exif\x00\x00"
MAKE, MODEL, DATETIME = 0x010F, 0x0110, 0x0132
EXIF_IFD, GPS_IFD = 0x8769, 0x8825
FOCAL_LENGTH, LENS_MODEL = 0x920A, 0xA434
GPS_LAT_REF, GPS_LAT, GPS_LON_REF, GPS_LON, GPS_ALT_REF, GPS_ALT = range(1, 7)

BYTE, ASCII, SHORT, LONG, RATIONAL = 1, 2, 3, 4, 5
_SIZE = {BYTE: 1, ASCII: 1, SHORT: 2, LONG: 4, RATIONAL: 8}
# the tags each IFD keeps; everything else is skipped
_WANTED = {"ifd0": (MAKE, MODEL, DATETIME, EXIF_IFD, GPS_IFD),
           "exif": (FOCAL_LENGTH, LENS_MODEL),
           "gps": tuple(range(1, 7))}
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_STANDALONE = set(range(0xD0, 0xD8)) | {0x01, 0xD8}


def _segments(data):
    """(marker, payload offset, payload length) of each segment of a JPEG's
    bytes up to its first SOS; raises ValueError for what is not a JPEG."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    pos = 2
    out = []
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:                  # fill byte
            pos += 1
            continue
        if marker in _STANDALONE:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if length < 2 or pos + 2 + length > len(data):
            raise ValueError(f"JPEG segment 0x{marker:02X} at byte {pos} "
                             "runs past the end of the file")
        out.append((marker, pos + 4, length - 2))
        if marker == 0xDA:                  # SOS: entropy-coded data next
            break
        pos += 2 + length
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _exif_segment(data):
    """(start, end) of the first Exif APP1's whole segment (marker
    included), or None."""
    for marker, off, n in _segments(data):
        if marker == 0xE1 and data[off:off + 6] == EXIF_HEADER:
            return off - 4, off + n
    return None


def _parse_ifd(tiff, bo, offset, wanted):
    """{tag: (type, values)} of one IFD's wanted entries; values are
    bytes for ASCII, a tuple of ints for BYTE/SHORT/LONG and a tuple of
    (numerator, denominator) for RATIONAL. Entries of other types, and
    entries whose data lies outside the TIFF block, are skipped."""
    out = {}
    if offset + 2 > len(tiff):
        return out
    n = struct.unpack(bo + "H", tiff[offset:offset + 2])[0]
    for k in range(n):
        e = offset + 2 + 12 * k
        if e + 12 > len(tiff):
            break
        tag, typ, count = struct.unpack(bo + "HHI", tiff[e:e + 8])
        if tag not in wanted or typ not in _SIZE:
            continue
        size = _SIZE[typ] * count
        if size <= 4:
            raw = tiff[e + 8:e + 8 + size]
        else:
            at = struct.unpack(bo + "I", tiff[e + 8:e + 12])[0]
            if at + size > len(tiff):
                continue
            raw = tiff[at:at + size]
        if typ == ASCII:
            val = bytes(raw)
        elif typ == RATIONAL:
            v = struct.unpack(bo + "%dI" % (2 * count), raw)
            val = tuple(zip(v[0::2], v[1::2]))
        else:
            val = struct.unpack(bo + "%d%s" % (count, "BBHI"[typ - 1]), raw)
        out[tag] = (typ, val)
    return out


def read_exif(image_file):
    """The reader's tags of a JPEG: {"ifd0": ..., "exif": ..., "gps": ...},
    each {tag: (type, values)} as _parse_ifd gives them; empty dicts for a
    file with no Exif APP1, or that is not a JPEG (a project's PNG)."""
    data = _read(image_file)
    tags = {"ifd0": {}, "exif": {}, "gps": {}}
    if data[:2] != b"\xff\xd8":
        return tags
    seg = _exif_segment(data)
    if seg is None:
        return tags
    tiff = data[seg[0] + 10:seg[1]]
    if tiff[:4] not in (b"II*\x00", b"MM\x00*"):
        return tags
    bo = "<" if tiff[:2] == b"II" else ">"
    ifd0 = struct.unpack(bo + "I", tiff[4:8])[0]
    tags["ifd0"] = _parse_ifd(tiff, bo, ifd0, _WANTED["ifd0"])
    for name, ptr in (("exif", EXIF_IFD), ("gps", GPS_IFD)):
        entry = tags["ifd0"].get(ptr)
        if entry is not None and entry[0] == LONG:
            tags[name] = _parse_ifd(tiff, bo, entry[1][0], _WANTED[name])
    return tags


def _value(entry):
    """A tag's value as PIL's getexif gives it to the reference: str for
    ASCII (latin-1, one trailing NUL dropped), a float for one RATIONAL
    (nan for a zero denominator, as PIL's IFDRational), a tuple of them
    for several, an int for one integer."""
    if entry is None:
        return None
    typ, val = entry
    if typ == ASCII:
        if val.endswith(b"\x00"):
            val = val[:-1]
        return val.decode("latin-1", "replace")
    if typ == RATIONAL:
        vals = tuple(n / d if d else float("nan") for n, d in val)
    else:
        vals = val
    return vals[0] if len(vals) == 1 else vals


def jpeg_size(image_file):
    """(width, height) of a JPEG from its SOF marker."""
    data = _read(image_file)
    for marker, off, _ in _segments(data):
        if marker in _SOF:
            h, w = struct.unpack(">HH", data[off + 1:off + 5])
            return w, h
    raise ValueError(f"{image_file}: no SOF marker before the scan")


def focal_length_mm(image_file):
    """The Exif IFD's FocalLength in mm, 0.0 when absent."""
    f = _value(read_exif(image_file)["exif"].get(FOCAL_LENGTH))
    return 0.0 if f is None else float(f)


def get_camera_info(image_file: str):
    """Returns (camera_key, make, model, lens_model) where camera_key is the
    cameras/<key>.json DB name: 'Make_Model[_Lens]' with spaces →
    underscores."""
    tags = read_exif(image_file)
    make = (_value(tags["ifd0"].get(MAKE)) or "").rstrip("\x00")
    model = (_value(tags["ifd0"].get(MODEL)) or "").rstrip("\x00")
    lens_model = _value(tags["exif"].get(LENS_MODEL))
    lens_model = lens_model.rstrip("\x00") if lens_model else None
    camera = make
    if model:
        camera += "_" + model
    if lens_model:
        camera += "_" + lens_model
    camera = camera.replace(" ", "_")
    return camera, make, model, lens_model


def _read_xmp(image_file: str) -> dict:
    """Scan the raw file for the x:xmpmeta packet and pull attribute-style
    tags, tolerant of both attribute (key="val") and element
    (<key>val</key>) XMP forms."""
    with open(image_file, "rb") as f:
        data = f.read()
    start = data.find(b"<x:xmpmeta")
    if start < 0:
        return {}
    end = data.find(b"</x:xmpmeta", start)
    blob = data[start: end + 12].decode("utf-8", errors="replace")
    xmp = {}
    for key, val in re.findall(r'([\w:-]+)="([^"]*)"', blob):
        xmp[key] = val
    for key, val in re.findall(r"<([\w:-]+)>([^<]+)</\1>", blob):
        xmp[key] = val
    return xmp


def get_pose(image_file: str):
    """Returns (lon_deg, lat_deg, alt_m, unixtime, yaw_deg, pitch_deg,
    roll_deg) — any may be None."""
    xmp = _read_xmp(image_file)
    tags = read_exif(image_file)
    gps = {k: _value(v) for k, v in tags["gps"].items()}
    dt_str = _value(tags["ifd0"].get(DATETIME))

    def dms(vals, ref):
        sign = -1.0 if str(ref) in ("S", "W", "s", "w") else 1.0
        d, m, s = (float(v) for v in vals)
        return sign * (d + m / 60.0 + s / 3600.0)

    if "drone-dji:GpsLatitude" in xmp:
        lat_deg = float(xmp["drone-dji:GpsLatitude"])
    elif GPS_LAT in gps:
        lat_deg = dms(gps[GPS_LAT], gps.get(GPS_LAT_REF, "N"))
    else:
        lat_deg = None
    if "drone-dji:GpsLongitude" in xmp:
        lon_deg = float(xmp["drone-dji:GpsLongitude"])
    elif GPS_LON in gps:
        lon_deg = dms(gps[GPS_LON], gps.get(GPS_LON_REF, "E"))
    else:
        lon_deg = None
    if "drone-dji:AbsoluteAltitude" in xmp:
        alt_m = float(xmp["drone-dji:AbsoluteAltitude"])
        if alt_m < 0:
            log("image meta data is reporting negative absolute altitude!")
    elif GPS_ALT in gps:
        # GPSAltitudeRef (below sea level) is ignored, as the reference
        alt_m = float(gps[GPS_ALT])
    else:
        alt_m = None

    unixtime = None
    if dt_str:
        strdate, strtime = str(dt_str).split()
        year, month, day = strdate.split(":")
        hour, minute, second = strtime.split(":")
        dt = datetime.datetime(int(year), int(month), int(day),
                               int(hour), int(minute), int(second))
        unixtime = dt.timestamp()

    def norm_yaw(y):
        while y < 0:
            y += 360
        return y

    yaw_deg = pitch_deg = roll_deg = None
    if xmp.get("tiff:Model") == "FC7303" and \
            "drone-dji:FlightYawDegree" in xmp:
        # the Mavic Mini 2 reports only flight yaw
        yaw_deg = norm_yaw(float(xmp["drone-dji:FlightYawDegree"]))
    elif "drone-dji:GimbalYawDegree" in xmp:
        yaw_deg = norm_yaw(float(xmp["drone-dji:GimbalYawDegree"]))
    elif "Camera:Yaw" in xmp:
        yaw_deg = norm_yaw(float(xmp["Camera:Yaw"]))

    if "drone-dji:GimbalPitchDegree" in xmp:
        pitch_deg = float(xmp["drone-dji:GimbalPitchDegree"])
    elif "Camera:Pitch" in xmp:
        pitch_deg = float(xmp["Camera:Pitch"])

    if "drone-dji:GimbalRollDegree" in xmp:
        roll_deg = float(xmp["drone-dji:GimbalRollDegree"])
    elif "Camera:Roll" in xmp:
        roll_deg = float(xmp["Camera:Roll"])

    return lon_deg, lat_deg, alt_m, unixtime, yaw_deg, pitch_deg, roll_deg


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _pack_ifd(entries, start, next_ifd=0):
    """One little-endian IFD at TIFF offset start: entries {tag: (type,
    values)} → bytes (the directory, then the data that does not fit
    inline)."""
    tags = sorted(entries)
    data_at = start + 2 + 12 * len(tags) + 4
    head = [struct.pack("<H", len(tags))]
    tail = b""
    for tag in tags:
        typ, val = entries[tag]
        if typ == ASCII:
            raw, count = val, len(val)
        elif typ == RATIONAL:
            raw = b"".join(struct.pack("<II", n, d) for n, d in val)
            count = len(val)
        else:
            raw = struct.pack("<%d%s" % (len(val), "BBHI"[typ - 1]), *val)
            count = len(val)
        if len(raw) <= 4:
            field = raw.ljust(4, b"\x00")
        else:
            field = struct.pack("<I", data_at + len(tail))
            tail += raw + (b"\x00" if len(raw) % 2 else b"")
        head.append(struct.pack("<HHI", tag, typ, count) + field)
    head.append(struct.pack("<I", next_ifd))
    return b"".join(head) + tail


def _dms_rational(deg):
    deg = abs(deg)
    d = int(deg)
    m = int((deg - d) * 60)
    s = ((deg - d) * 60 - m) * 60
    return ((d, 1), (m, 1), (int(round(s * 10000)), 10000))


def exif_segment(ifd0, exif_ifd, gps):
    """An Exif APP1 segment (marker included) holding IFD0, the Exif IFD
    (when it has entries) and the GPS IFD (when it has entries): each a
    {tag: (type, values)}, written little-endian."""
    ifd0 = {k: v for k, v in ifd0.items() if k not in (EXIF_IFD, GPS_IFD)}
    subs = [(EXIF_IFD, exif_ifd), (GPS_IFD, gps)]
    subs = [(ptr, e) for ptr, e in subs if e]
    for ptr, _ in subs:
        ifd0[ptr] = (LONG, (0,))            # sized now, filled below
    size0 = len(_pack_ifd(ifd0, 8))
    at, blobs = 8 + size0, []
    for ptr, entries in subs:
        ifd0[ptr] = (LONG, (at,))
        blobs.append(_pack_ifd(entries, at))
        at += len(blobs[-1])
    tiff = b"II*\x00" + struct.pack("<I", 8) + _pack_ifd(ifd0, 8) \
        + b"".join(blobs)
    payload = EXIF_HEADER + tiff
    if len(payload) + 2 > 0xFFFF:
        raise ValueError("Exif segment larger than a JPEG segment holds")
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def write_geotag(image_file, lat_deg, lon_deg, alt_m, unixtime=None,
                 out_file=None):
    """Write the GPS tags (and DateTime from unixtime, local time) into a
    JPEG's Exif APP1, to out_file or in place. The Make, Model, DateTime,
    FocalLength and LensModel entries already there are kept; the rest of
    the file is copied byte for byte."""
    tags = read_exif(image_file)
    gps = {
        GPS_LAT_REF: (ASCII, b"N\x00" if lat_deg >= 0 else b"S\x00"),
        GPS_LAT: (RATIONAL, _dms_rational(lat_deg)),
        GPS_LON_REF: (ASCII, b"E\x00" if lon_deg >= 0 else b"W\x00"),
        GPS_LON: (RATIONAL, _dms_rational(lon_deg)),
        GPS_ALT_REF: (BYTE, (0 if alt_m >= 0 else 1,)),
        GPS_ALT: (RATIONAL, ((int(round(abs(alt_m) * 100)), 100),)),
    }
    ifd0 = dict(tags["ifd0"])
    if unixtime is not None:
        dt = datetime.datetime.fromtimestamp(unixtime)
        ifd0[DATETIME] = (ASCII,
                          dt.strftime("%Y:%m:%d %H:%M:%S").encode() + b"\0")
    write_segment(image_file, exif_segment(ifd0, tags["exif"], gps),
                  out_file)


def write_segment(image_file, segment, out_file=None):
    """Put an Exif APP1 segment (exif_segment's) into a JPEG, to out_file
    or in place: in place of the first Exif APP1, else after SOI and any
    APP0 (JFIF) segments. Every other byte is copied as it is."""
    data = _read(image_file)
    old = _exif_segment(data)
    if old is not None:
        out = data[:old[0]] + segment + data[old[1]:]
    else:
        at = 2
        for marker, off, n in _segments(data):
            if marker != 0xE0:
                break
            at = off + n
        out = data[:at] + segment + data[at:]
    dst = out_file or image_file
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, dst)
