"""Audio IO: WAV + FLAC via the native C++ decoder (ctypes), with a pure-numpy
WAV fallback so the framework degrades gracefully if the library cannot be
built.

Replaces the reference's soundfile dependency (reference src/data/data.py:7-15:
ranged read with whole-file fallback). A copy of the JAX package's
utils/audio_io.py with its own copy of the decoder source
(``native/audio_decoder.cpp``), which g++ builds at first use into
``_build/`` under a name that carries a hash of the source. This is host
file IO: no device runs it.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "audio_decoder.cpp"
_BUILD = _PKG / "_build"
_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the decoder's shared library is (or will be) built."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return _BUILD / f"libpseldaudio-{digest}.so"


def _build_native() -> Optional[Path]:
    if not _SRC.exists():
        return None
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    # build to a per-process temp path, then atomically rename: a concurrent
    # process must never CDLL a partially-written .so
    tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
             "-o", str(tmp)],
            check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except Exception:
        tmp.unlink(missing_ok=True)
        return None


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _build_native()
        if path is None or not Path(path).exists():
            _lib = False
            return _lib
        lib = ctypes.CDLL(str(path))
        lib.audio_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.POINTER(ctypes.c_int32)]
        lib.audio_info.restype = ctypes.c_int
        lib.audio_read_f32.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64, ctypes.c_int64]
        lib.audio_read_f32.restype = ctypes.c_int
        _lib = lib
        return _lib


def audio_info(path) -> Tuple[int, int, int]:
    """-> (frames, channels, samplerate)."""
    lib = _get_lib()
    if lib:
        frames = ctypes.c_int64()
        ch = ctypes.c_int32()
        sr = ctypes.c_int32()
        rc = lib.audio_info(str(path).encode(), ctypes.byref(frames),
                            ctypes.byref(ch), ctypes.byref(sr))
        if rc == 0:
            return frames.value, ch.value, sr.value
    return _wav_info_numpy(path)


def load_audio(path, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
    """-> float32 (channels, stop-start). Mirrors reference load_audio
    semantics (ranged read; the native decoder handles ranging internally)."""
    frames, ch, _ = audio_info(path)
    if stop is None:
        stop = frames
    stop = min(stop, frames)
    lib = _get_lib()
    if lib:
        out = np.empty((ch, stop - start), np.float32)
        rc = lib.audio_read_f32(str(path).encode(),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                start, stop)
        if rc == 0:
            return out
    return _wav_read_numpy(path, start, stop)


# ---------------------------------------------------------------------------
# numpy WAV fallback
# ---------------------------------------------------------------------------
def _wav_chunks(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE", f"not a WAV: {path}"
    off = 12
    chunks = {}
    while off + 8 <= len(data):
        cid = data[off:off + 4]
        clen = int.from_bytes(data[off + 8 - 4:off + 8], "little")
        chunks[cid] = (off + 8, clen)
        off += 8 + clen + (clen & 1)
    return data, chunks


def _wav_info_numpy(path):
    data, chunks = _wav_chunks(path)
    fo, _ = chunks[b"fmt "]
    ch = int.from_bytes(data[fo + 2:fo + 4], "little")
    sr = int.from_bytes(data[fo + 4:fo + 8], "little")
    bits = int.from_bytes(data[fo + 14:fo + 16], "little")
    _, dlen = chunks[b"data"]
    return dlen // (ch * bits // 8), ch, sr


def _wav_read_numpy(path, start, stop):
    data, chunks = _wav_chunks(path)
    fo, _ = chunks[b"fmt "]
    fmt = int.from_bytes(data[fo:fo + 2], "little")
    ch = int.from_bytes(data[fo + 2:fo + 4], "little")
    bits = int.from_bytes(data[fo + 14:fo + 16], "little")
    do, dlen = chunks[b"data"]
    raw = data[do:do + dlen]
    if fmt == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4").reshape(-1, ch)
    elif fmt == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").reshape(-1, ch).astype(np.float32) / 32768.0
    else:
        raise NotImplementedError(f"WAV fmt={fmt} bits={bits}")
    return np.ascontiguousarray(x[start:stop].T.astype(np.float32))


def write_wav(path, audio: np.ndarray, samplerate: int):
    """float32 (channels, frames) -> 32-bit float WAV (test/tooling helper)."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    ch, frames = audio.shape
    inter = np.ascontiguousarray(audio.T).tobytes()
    with open(path, "wb") as f:
        hdr_len = 36 + len(inter)
        f.write(b"RIFF" + (hdr_len).to_bytes(4, "little") + b"WAVE")
        f.write(b"fmt " + (16).to_bytes(4, "little"))
        f.write((3).to_bytes(2, "little"))  # IEEE float
        f.write(ch.to_bytes(2, "little"))
        f.write(samplerate.to_bytes(4, "little"))
        f.write((samplerate * ch * 4).to_bytes(4, "little"))
        f.write((ch * 4).to_bytes(2, "little"))
        f.write((32).to_bytes(2, "little"))
        f.write(b"data" + len(inter).to_bytes(4, "little"))
        f.write(inter)
