"""Weight data file: LUT-indexed on-disk store + plaintext manager.

The `ace_tpu.runtime.rt_data` weight file, byte for byte the same format
(a file written by either package reads in the other), the port's analog
of the reference's rt_data subsystem:
  - writer:  fhe-cmplr/include/fhe/core/rt_data_writer.h:62-71 (compiler
    side emits the `.msg` file with DE_MSG_F32/DE_PLAINTEXT entries,
    rt_data_def.h:44-53)
  - reader:  rtlib common/rt_data_file.h:25-39 + pt_mgr.h:28-31
    (`Pt_get(index, len, scale, level)`, `Pt_prefetch`)

Design: little-endian header + entry LUT + 64-byte-aligned blobs.
Entries are either raw float32 messages (encoded on the fly at the
level/scale the op needs — the default) or pre-encoded RNS plaintexts
(the `-P2C:cte` compile-time-encoding analog, encode_context.c:25-46),
stored as uint64 residues and lifted to the port's int64 bit pattern on
the encoder's device. Prefetch goes through the native async loader
(runtime/block_io.py), or mmap readahead hints when the manager has no
file path or is built with async_io=False.
"""

from __future__ import annotations

import mmap
import struct
import threading

import numpy as np

MAGIC = b"ACETPUD1"
KIND_F32 = 0
KIND_F64 = 1
KIND_PLAIN = 2  # pre-encoded RNS plaintext: uint64 [level, degree]

_HDR = struct.Struct("<8sII")           # magic, version, entry count
_ENT = struct.Struct("<64sIIQQdII")     # name, kind, len, offset, nbytes,
                                        # scale, sf_degree, level


class RtDataWriter:
    """Append named weight entries, then write the LUT file."""

    def __init__(self):
        self._entries = []

    def append(self, name: str, data: np.ndarray):
        """Raw message entry (RT_DATA_WRITER::Append)."""
        arr = np.ascontiguousarray(data, dtype=np.float32)
        self._entries.append((name, KIND_F32, arr.size, arr.tobytes(),
                              0.0, 0, 0))

    def append_f64(self, name: str, data: np.ndarray):
        arr = np.ascontiguousarray(data, dtype=np.float64)
        self._entries.append((name, KIND_F64, arr.size, arr.tobytes(),
                              0.0, 0, 0))

    def append_pt(self, name: str, rns_data: np.ndarray, scale: float,
                  sf_degree: int, level: int, msg_len: int):
        """Pre-encoded plaintext entry (RT_DATA_WRITER::Append_pt)."""
        arr = np.ascontiguousarray(rns_data, dtype=np.uint64)
        self._entries.append((name, KIND_PLAIN, msg_len, arr.tobytes(),
                              scale, sf_degree, level))

    def write(self, path: str):
        off = _HDR.size + _ENT.size * len(self._entries)
        lut = []
        blobs = []
        for name, kind, length, blob, scale, sfd, level in self._entries:
            off = (off + 63) & ~63
            lut.append((name.encode()[:64], kind, length, off, len(blob),
                        scale, sfd, level))
            blobs.append((off, blob))
            off += len(blob)
        with open(path, "wb") as f:
            f.write(_HDR.pack(MAGIC, 1, len(lut)))
            for e in lut:
                f.write(_ENT.pack(*e))
            for off, blob in blobs:
                f.seek(off)
                f.write(blob)


class RtDataReader:
    """mmap-backed LUT reader with index and name lookup."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, count = _HDR.unpack_from(self._mm, 0)
        if magic != MAGIC:
            raise ValueError(f"bad data file magic {magic!r}")
        self.entries = []
        self.by_name = {}
        for i in range(count):
            raw = _ENT.unpack_from(self._mm, _HDR.size + i * _ENT.size)
            name = raw[0].rstrip(b"\0").decode()
            ent = dict(name=name, kind=raw[1], len=raw[2], offset=raw[3],
                       nbytes=raw[4], scale=raw[5], sf_degree=raw[6],
                       level=raw[7])
            self.entries.append(ent)
            self.by_name[name] = i

    def prefetch(self, index: int):
        """Hint the kernel to stage this entry (Pt_prefetch analog)."""
        ent = self.entries[index]
        page = mmap.PAGESIZE
        start = ent["offset"] & ~(page - 1)
        length = ent["nbytes"] + (ent["offset"] - start)
        try:
            self._mm.madvise(mmap.MADV_WILLNEED, start, length)
        except (AttributeError, ValueError):
            pass

    def read(self, index: int) -> tuple[dict, np.ndarray]:
        ent = self.entries[index]
        o, nb = ent["offset"], ent["nbytes"]
        # copy out of the map so the reader can close independently of
        # array lifetimes (arrays immediately become device buffers)
        if ent["kind"] == KIND_F32:
            arr = np.frombuffer(self._mm, np.float32, nb // 4, o).copy()
        elif ent["kind"] == KIND_F64:
            arr = np.frombuffer(self._mm, np.float64, nb // 8, o).copy()
        else:
            arr = np.frombuffer(self._mm, np.uint64, nb // 8, o).copy()
        return ent, arr

    def close(self):
        self._mm.close()
        self._f.close()


class PtManager:
    """Plaintext weight manager: encode-on-demand with async prefetch
    (pt_mgr.h Pt_get/Pt_prefetch). With a file path and async_io (the
    default), prefetch goes through the native io_uring loader
    (runtime/block_io.py, block_io_linux.c:10-22 analog); a loader that
    fails to build or open raises. Otherwise prefetch is an mmap
    readahead hint."""

    def __init__(self, reader: RtDataReader, encoder, path: str = "",
                 async_io: bool = True):
        self.reader = reader
        self.encoder = encoder
        self._cache = {}
        self._lock = threading.Lock()
        self._aio = None
        self._pending: dict[str, int] = {}
        if path and async_io:
            from ace_tpu_torch.runtime.block_io import AsyncBlockLoader
            self._aio = AsyncBlockLoader(path)

    @property
    def bio_engine(self) -> str:
        """The native loader's engine ("io_uring" or "threadpool"), or
        "mmap" when prefetch uses readahead hints."""
        return self._aio.engine if self._aio is not None else "mmap"

    def prefetch(self, name: str):
        idx = self.reader.by_name.get(name)
        if idx is None:
            return
        if self._aio is not None:
            with self._lock:
                if name in self._pending:
                    return
                # already decoded at some (level, sf_degree): a new read
                # would never be waited on and would pin its buffer
                if any(k[0] == name for k in self._cache):
                    return
                ent = self.reader.entries[idx]
                self._pending[name] = self._aio.submit(
                    ent["offset"], ent["nbytes"])
            return
        threading.Thread(target=self.reader.prefetch, args=(idx,),
                         daemon=True).start()

    def _read(self, name: str, idx: int):
        """Entry + raw array, consuming a pending async read if one is
        in flight for this name."""
        tok = None
        if self._aio is not None:
            with self._lock:
                tok = self._pending.pop(name, None)
        if tok is None:
            return self.reader.read(idx)
        ent = self.reader.entries[idx]
        raw = self._aio.wait(tok)
        dt = {KIND_F32: np.float32, KIND_F64: np.float64}.get(
            ent["kind"], np.uint64)
        return ent, raw.view(dt)

    def get(self, name: str, level: int, sf_degree: int = 1):
        """Encoded plaintext for entry `name` at (level, sf_degree)."""
        key = (name, level, sf_degree)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        idx = self.reader.by_name[name]
        ent, arr = self._read(name, idx)
        if ent["kind"] == KIND_PLAIN:
            from ace_tpu_torch.ckks.encoder import Plaintext
            from ace_tpu_torch.ops.modops import to_torch
            from ace_tpu_torch.poly.poly import RnsPoly
            lv = ent["level"]
            if lv != level or ent["sf_degree"] != sf_degree:
                raise ValueError(
                    f"pre-encoded plaintext {name!r} stored at "
                    f"(level={lv}, sf_degree={ent['sf_degree']}) but "
                    f"requested (level={level}, sf_degree={sf_degree}); "
                    f"re-run compile-time encoding at the right level")
            data = to_torch(self.encoder.params.crt.put(arr.reshape(lv, -1)),
                            self.encoder.device)
            pt = Plaintext(RnsPoly(data, lv, 0, True), ent["scale"],
                           ent["sf_degree"], ent["len"])
        else:
            msg = np.zeros(self.encoder.params.slots, np.complex128)
            msg[:len(arr)] = arr
            pt = self.encoder.encode(msg, level=level, sf_degree=sf_degree)
        with self._lock:
            self._cache[key] = pt
        return pt
