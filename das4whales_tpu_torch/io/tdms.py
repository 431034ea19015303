"""Minimal native TDMS (National Instruments) reader/writer (the port's
copy of ``das4whales_tpu.io.tdms``, host numpy).

The reference reads Silixa interrogator files through the third-party
``nptdms`` wheel (data_handle.py:113-154). That package is not part of this
framework's dependency set, so this module implements the TDMS container
format directly from the public specification: segment lead-ins, ToC flags,
object metadata with raw-data indexes, property tables, and contiguous
(non-interleaved) raw data chunks — everything a Silixa DAS file uses.

Scope (asserted, not silently wrong): little-endian, non-interleaved,
non-DAQmx segments with numeric channel data; properties of numeric,
string, bool and timestamp types.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Dict

import numpy as np

# ToC flag bits
_TOC_METADATA = 1 << 1
_TOC_NEW_OBJ_LIST = 1 << 2
_TOC_RAW_DATA = 1 << 3
_TOC_INTERLEAVED = 1 << 5
_TOC_BIG_ENDIAN = 1 << 6
_TOC_DAQMX = 1 << 7

# TDMS dtype ids -> numpy dtypes
_TDMS_DTYPES = {
    1: np.dtype("int8"),
    2: np.dtype("int16"),
    3: np.dtype("int32"),
    4: np.dtype("int64"),
    5: np.dtype("uint8"),
    6: np.dtype("uint16"),
    7: np.dtype("uint32"),
    8: np.dtype("uint64"),
    9: np.dtype("float32"),
    10: np.dtype("float64"),
}
_NUMPY_TO_TDMS = {v: k for k, v in _TDMS_DTYPES.items()}
_TYPE_STRING = 0x20
_TYPE_BOOL = 0x21
_TYPE_TIMESTAMP = 0x44

# the TDMS epoch is UTC; an AWARE datetime keeps .timestamp() (and hence
# every t0_us derived from GPSTimeStamp) correct on non-UTC hosts — a
# naive epoch would silently shift campaign pick times by the local
# UTC offset
_EPOCH_1904 = datetime(1904, 1, 1, tzinfo=timezone.utc)


def _parse_path(path: str):
    """TDMS object path -> tuple of unescaped components.

    ``/`` is the file root, ``/'Group'`` a group, ``/'Group'/'Chan'`` a
    channel; quotes inside names are doubled.
    """
    if path == "/":
        return ()
    parts = []
    assert path.startswith("/"), path
    rest = path[1:]
    while rest:
        assert rest.startswith("'"), path
        end = 1
        while True:
            end = rest.index("'", end)
            if rest[end : end + 2] == "''":
                end += 2
                continue
            break
        parts.append(rest[1:end].replace("''", "'"))
        rest = rest[end + 1 :]
        if rest.startswith("/"):
            rest = rest[1:]
    return tuple(parts)


class _Cursor:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated TDMS data")
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def string(self) -> str:
        return self.read(self.u32()).decode("utf-8")

    def value(self, type_id: int):
        if type_id in _TDMS_DTYPES:
            dt = _TDMS_DTYPES[type_id]
            return np.frombuffer(self.read(dt.itemsize), dtype=dt)[0].item()
        if type_id == _TYPE_STRING:
            return self.string()
        if type_id == _TYPE_BOOL:
            return bool(self.read(1)[0])
        if type_id == _TYPE_TIMESTAMP:
            frac = struct.unpack("<Q", self.read(8))[0]
            secs = struct.unpack("<q", self.read(8))[0]
            return _EPOCH_1904 + timedelta(seconds=secs + frac / 2**64)
        raise NotImplementedError(f"TDMS property type 0x{type_id:x}")


@dataclass
class _RawIndex:
    dtype: np.dtype
    n_values: int


def _iter_segment_objects(cur: "_Cursor"):
    """Walk ONE segment's metadata block: yields
    ``(path, index, props)`` per object, where ``index`` is
    ``("none",)`` (property-only object), ``("reuse",)`` (raw-index
    carried over from an earlier segment) or
    ``("new", type_id, dim, n_values)``. The ONE metadata parser —
    ``TdmsFile.read`` and the native-layout probe both walk through
    here, so a format accommodation cannot land in only one of them."""
    n_objects = cur.u32()
    for _ in range(n_objects):
        path = _parse_path(cur.string())
        idx_len = cur.u32()
        if idx_len == 0xFFFFFFFF:
            index = ("none",)
        elif idx_len == 0x00000000:
            index = ("reuse",)
        else:
            type_id = cur.u32()
            dim = cur.u32()
            n_values = cur.u64()
            if type_id == _TYPE_STRING:
                cur.u64()  # total raw bytes of the string channel
            index = ("new", type_id, dim, n_values)
        props = {}
        n_props = cur.u32()
        for _ in range(n_props):
            name = cur.string()
            props[name] = cur.value(cur.u32())
        yield path, index, props


@dataclass
class TdmsObject:
    path: tuple
    properties: dict = field(default_factory=dict)
    data_parts: list = field(default_factory=list)

    @property
    def data(self) -> np.ndarray:
        if not self.data_parts:
            return np.empty(0)
        if len(self.data_parts) == 1:
            return self.data_parts[0]
        return np.concatenate(self.data_parts)


class TdmsFile:
    """Parsed TDMS file: root/group properties and channel data arrays."""

    def __init__(self):
        self.objects: Dict[tuple, TdmsObject] = {}

    @property
    def properties(self) -> dict:
        obj = self.objects.get(())
        return obj.properties if obj else {}

    def groups(self):
        return sorted({p[0] for p in self.objects if len(p) >= 1})

    def channels(self, group: str):
        return [p[1] for p in sorted(self.objects) if len(p) == 2 and p[0] == group]

    def __getitem__(self, group: str) -> Dict[str, np.ndarray]:
        return {c: self.objects[(group, c)].data for c in self.channels(group)}

    def group_properties(self, group: str) -> dict:
        obj = self.objects.get((group,))
        return obj.properties if obj else {}

    @classmethod
    def read(cls, filepath: str) -> "TdmsFile":
        with open(filepath, "rb") as f:
            buf = f.read()
        self = cls()
        pos = 0
        # raw-data object order + indexes carry over between segments
        active: list[tuple] = []
        in_active: set = set()     # membership of ``active`` in O(1) a channel
        indexes: Dict[tuple, _RawIndex] = {}
        while pos < len(buf):
            if len(buf) - pos < 28:
                break  # trailing padding
            tag, toc, _version, next_off, raw_off = struct.unpack(
                "<4sIIQQ", buf[pos : pos + 28]
            )
            if tag != b"TDSm":
                raise ValueError(f"bad TDMS segment tag at byte {pos}")
            if toc & _TOC_BIG_ENDIAN:
                raise NotImplementedError("big-endian TDMS segments")
            if toc & _TOC_DAQMX:
                raise NotImplementedError("DAQmx raw data")
            data_start = pos + 28 + raw_off
            seg_end = pos + 28 + next_off
            if next_off == 0xFFFFFFFFFFFFFFFF:  # crashed writer: data to EOF
                seg_end = len(buf)

            if toc & _TOC_METADATA:
                cur = _Cursor(buf, pos + 28)
                if toc & _TOC_NEW_OBJ_LIST:
                    active, in_active = [], set()
                for path, index, props in _iter_segment_objects(cur):
                    obj = self.objects.setdefault(path, TdmsObject(path))
                    if index[0] == "reuse":
                        if path not in in_active:
                            active.append(path)  # reuse previous index
                            in_active.add(path)
                    elif index[0] == "new":
                        _, type_id, dim, n_values = index
                        if type_id == _TYPE_STRING:
                            raise NotImplementedError("string channel data")
                        if dim != 1:
                            raise NotImplementedError("multi-dimensional TDMS arrays")
                        indexes[path] = _RawIndex(_TDMS_DTYPES[type_id], n_values)
                        if path not in in_active:
                            active.append(path)
                            in_active.add(path)
                    obj.properties.update(props)

            if toc & _TOC_RAW_DATA:
                if toc & _TOC_INTERLEAVED:
                    raise NotImplementedError("interleaved raw data")
                chunk = sum(
                    indexes[p].dtype.itemsize * indexes[p].n_values for p in active
                )
                dpos = data_start
                while chunk > 0 and dpos + chunk <= seg_end:
                    for p in active:
                        ix = indexes[p]
                        nbytes = ix.dtype.itemsize * ix.n_values
                        # a view of the file's bytes: no copy a channel
                        arr = np.frombuffer(buf, dtype=ix.dtype, count=ix.n_values,
                                            offset=dpos)
                        self.objects[p].data_parts.append(arr)
                        dpos += nbytes
            pos = seg_end
        return self


def read_measurement_block(filepath: str, start: int, stop: int, step: int,
                           *, raw: bool = False):
    """Host bulk read of a Silixa file's ``Measurement`` group: the
    ``[start:stop:step]`` channel selection stacked ``[n_sel x ns]`` in
    natural name order. ``raw=True`` keeps the STORED dtype (the narrow
    wire format — int16 counts stay int16 for the host→device transfer,
    conditioning runs on device via ``ops.conditioning``); ``raw=False``
    casts to float32 for the host conditioning path. Returns
    ``(block, t0_us or None)`` with ``t0_us`` from ``GPSTimeStamp`` when
    present. The ONE TDMS bulk-selection routine — the stream's
    conditioned and raw readers both come through here, so channel
    ordering cannot drift between wire formats."""
    from .interrogators import _natural_key

    f = TdmsFile.read(filepath)
    channels = f["Measurement"]
    names = sorted(channels, key=_natural_key)[start:stop:step]
    stack = np.stack([channels[c] for c in names])
    if not raw:
        stack = stack.astype(np.float32)
    t0 = f.properties.get("GPSTimeStamp")
    t0_us = int(t0.timestamp() * 1e6) if hasattr(t0, "timestamp") else None
    return stack, t0_us


def contiguous_layout(filepath: str):
    """Native-ingest layout probe: ``(data_offset, dtype, nx, ns, t0_us)``
    when the file is ONE TDMS segment whose ``Measurement`` channels are
    equal-length, same-dtype and stored contiguously channel-after-channel
    in natural name order — byte-identical to the ``[nx x ns]`` row-major
    block the C++ engine reads (native/ingest.cpp; the same split as the
    HDF5 path: host parses metadata once, the engine preads the bulk).
    Returns ``None`` for anything irregular (multi-segment, multi-chunk,
    interleaved, mixed dtypes, non-natural channel order) — the pure-host
    reader handles those. Reads ONLY the lead-in + metadata block.
    """
    from .interrogators import _natural_key

    try:
        with open(filepath, "rb") as f:
            head = f.read(28)
            if len(head) < 28:
                return None
            tag, toc, _version, next_off, raw_off = struct.unpack(
                "<4sIIQQ", head
            )
            if tag != b"TDSm":
                return None
            bad = _TOC_BIG_ENDIAN | _TOC_DAQMX | _TOC_INTERLEAVED
            if (toc & bad) or not (toc & _TOC_METADATA) or not (toc & _TOC_RAW_DATA):
                return None
            meta = f.read(raw_off)
            if len(meta) < raw_off:
                return None
            f.seek(0, 2)
            fsize = f.tell()
            seg_end = fsize if next_off == 0xFFFFFFFFFFFFFFFF else 28 + next_off
            if seg_end > fsize:
                return None
            if fsize - seg_end >= 28:
                # enough room for another segment header: whether it is a
                # real segment or corruption, the host reader is the
                # arbiter (it parses further segments, or raises on a bad
                # tag — the native engine must not silently serve a
                # truncated view the fallback engine would reject)
                return None
    except OSError:
        return None

    cur = _Cursor(meta, 0)
    chans: list = []
    t0 = None
    try:
        for path, index, props in _iter_segment_objects(cur):
            if path == () and "GPSTimeStamp" in props:
                t0 = props["GPSTimeStamp"]
            if index[0] == "reuse":
                return None  # index reuse implies an earlier segment
            if index[0] == "new":
                _, type_id, dim, n_values = index
                if type_id == _TYPE_STRING or dim != 1:
                    return None
                dtype = _TDMS_DTYPES.get(type_id)
                if dtype is None:
                    return None
                if len(path) != 2 or path[0] != "Measurement":
                    return None
                chans.append((path[1], dtype, int(n_values)))
    except Exception:  # noqa: BLE001 — malformed metadata -> host reader
        return None

    if not chans:
        return None
    names = [c[0] for c in chans]
    if names != sorted(names, key=_natural_key):
        # the host reader selects channels in natural name order; native
        # row slicing must agree with it or the selection silently shifts
        return None
    dtypes = {np.dtype(c[1]) for c in chans}
    lengths = {c[2] for c in chans}
    if len(dtypes) != 1 or len(lengths) != 1:
        return None
    dt = dtypes.pop()
    if dt not in (np.dtype(np.int16), np.dtype(np.int32),
                  np.dtype(np.float32), np.dtype(np.float64)):
        return None
    ns = lengths.pop()
    nx = len(chans)
    chunk = nx * ns * dt.itemsize
    avail = seg_end - (28 + raw_off)
    if avail < chunk or avail >= 2 * chunk:
        return None  # incomplete, or multiple chunks (data would repeat)
    t0_us = int(t0.timestamp() * 1e6) if hasattr(t0, "timestamp") else 0
    return (28 + raw_off, dt, nx, ns, t0_us)


def write_tdms(
    filepath: str,
    root_properties: dict,
    group: str,
    channels: Dict[str, np.ndarray],
) -> str:
    """Write a single-segment, non-interleaved TDMS file (for fixtures,
    tests, and data export)."""

    def enc_string(s: str) -> bytes:
        raw = s.encode("utf-8")
        return struct.pack("<I", len(raw)) + raw

    def enc_path(parts) -> bytes:
        if not parts:
            return enc_string("/")
        return enc_string("/" + "/".join("'" + p.replace("'", "''") + "'" for p in parts))

    def enc_prop(name: str, value) -> bytes:
        out = enc_string(name)
        if isinstance(value, bool):
            return out + struct.pack("<I", _TYPE_BOOL) + struct.pack("<B", value)
        if isinstance(value, (int, np.integer)):
            return out + struct.pack("<I", 3) + struct.pack("<i", int(value))
        if isinstance(value, (float, np.floating)):
            return out + struct.pack("<I", 10) + struct.pack("<d", float(value))
        if isinstance(value, str):
            return out + struct.pack("<I", _TYPE_STRING) + enc_string(value)
        if isinstance(value, datetime):
            if value.tzinfo is None:
                value = value.replace(tzinfo=timezone.utc)  # TDMS times are UTC
            delta = value - _EPOCH_1904
            secs = int(delta.total_seconds())
            frac = int((delta.total_seconds() - secs) * 2**64)
            return out + struct.pack("<I", _TYPE_TIMESTAMP) + struct.pack("<Qq", frac, secs)
        raise TypeError(f"unsupported property type {type(value)}")

    # parts are joined once: a file of 22050 channels must not grow a bytes
    # object 22050 times
    meta = [struct.pack("<I", 2 + len(channels))]
    # root object with properties
    meta += [enc_path(()), struct.pack("<I", 0xFFFFFFFF), struct.pack("<I", len(root_properties))]
    meta += [enc_prop(k, v) for k, v in root_properties.items()]
    # group object
    meta += [enc_path((group,)), struct.pack("<I", 0xFFFFFFFF), struct.pack("<I", 0)]
    # channel objects
    arrays = [np.ascontiguousarray(arr) for arr in channels.values()]
    for name, arr in zip(channels, arrays):
        meta += [
            enc_path((group, name)),
            struct.pack("<I", 20),  # index block length
            struct.pack("<I", _NUMPY_TO_TDMS[arr.dtype]),
            struct.pack("<I", 1),
            struct.pack("<Q", arr.size),
            struct.pack("<I", 0),  # no channel properties
        ]
    meta = b"".join(meta)
    n_raw = sum(arr.nbytes for arr in arrays)

    toc = _TOC_METADATA | _TOC_NEW_OBJ_LIST | _TOC_RAW_DATA
    lead = struct.pack("<4sIIQQ", b"TDSm", toc, 4713, len(meta) + n_raw, len(meta))
    with open(filepath, "wb") as f:
        f.write(lead + meta)
        for arr in arrays:
            f.write(arr.data)
    return filepath
