"""The native data core: ctypes bindings over the C ABI of ``data_core.cpp``.

``data_core.cpp`` (libjpeg decode with DCT-domain prescaling, bilinear
resize, a fused normalise-into-canvas pass, a threaded batch decode) is
compiled with ``g++`` at first use into ``build/native/`` at the repository
root (git-ignored), never next to the source: to a file of its own, renamed
into place, so processes that build at once do not collide. A dataset that
decodes builds it in its constructor, in the parent process, before any
loader worker starts.

It is compiled against the ABI-62 headers kept in ``jpeg62/`` and linked
to the first runtime ``libjpeg.so.62`` found: the system's, else the
libjpeg-turbo that Pillow's wheel carries in ``pillow.libs/``. Where it
cannot be built, ``lib()`` raises with the compiler's output; nothing falls
back to another decoder.
"""

import ctypes
import glob
import hashlib
import importlib.util
import os
import re
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "data_core.cpp"
JPEG62_HEADERS = NATIVE_DIR / "jpeg62"
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib = None
_error = None


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", ctypes.c_void_p)]


def _pillow_libjpeg():
    """The libjpeg-turbo (ABI 62) that Pillow's wheel carries, or None."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or spec.origin is None:
        return None
    libs = Path(spec.origin).resolve().parents[1] / "pillow.libs"
    found = sorted(glob.glob(str(libs / "libjpeg*.so.62*")))
    return found[0] if found else None


def _file_of(cdll):
    """The file a loaded libjpeg came from: the one that holds its
    ``jpeg_std_error`` (``dladdr``)."""
    address = ctypes.cast(cdll.jpeg_std_error, ctypes.c_void_p)
    info = _DlInfo()
    if not ctypes.CDLL(None).dladdr(address, ctypes.byref(info)):
        raise RuntimeError("dladdr found no library for jpeg_std_error")
    return info.dli_fname.decode()


def runtime_libjpeg62():
    """The libjpeg of ABI 62 the core links: the system's
    ``libjpeg.so.62`` (found by the dynamic loader, so no compiler or
    ``ldconfig`` runs), else Pillow's; None where there is neither."""
    try:
        return _file_of(ctypes.CDLL("libjpeg.so.62"))
    except OSError:
        return _pillow_libjpeg()


def _link_flags(runtime):
    return (runtime, f"-Wl,-rpath,{os.path.dirname(runtime)}")


def _library_path(runtime):
    headers = b"".join(p.read_bytes()
                       for p in sorted(JPEG62_HEADERS.glob("*.h")))
    key = SOURCE.read_bytes() + headers + " ".join(
        (*CXX_FLAGS, *_link_flags(runtime))).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"libsaicv_data_{digest}.so"


def _compile(runtime, output):
    """g++ the core into ``output`` (through a file of this process's own,
    renamed into place); raises RuntimeError with g++'s output."""
    tmp = output.with_name(f"{output.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, f"-I{JPEG62_HEADERS}", str(SOURCE),
           *_link_flags(runtime), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"$ {' '.join(cmd)}\nno g++: {exc}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"$ {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, output)


def _load():
    """The core linked against ``runtime_libjpeg62()``, built first where
    this machine has not built it yet (a worker process finds the parent's
    build under the same name and only loads it)."""
    runtime = runtime_libjpeg62()
    if runtime is None:
        raise RuntimeError("native data core: no libjpeg.so.62 (neither the "
                           "system's nor Pillow's)")
    output = _library_path(runtime)
    if not output.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(runtime, output)
    try:
        return ctypes.CDLL(str(output))
    except OSError as exc:
        raise RuntimeError(f"native data core: {output}: {exc}") from None


def lib():
    """The loaded core, built first if needed. Raises RuntimeError (with
    g++'s output) when it cannot be built; the failure is kept, so later
    calls raise at once."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(_error)
    try:
        cdll = _load()
    except RuntimeError as exc:
        _error = str(exc)
        raise
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cdll.saicv_decode_jpeg.restype = u8p
    cdll.saicv_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    cdll.saicv_free.restype = None
    cdll.saicv_free.argtypes = [ctypes.c_void_p]
    cdll.saicv_normalize_into_canvas.restype = None
    cdll.saicv_normalize_into_canvas.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    cdll.saicv_decode_jpeg_batch.restype = ctypes.c_int
    cdll.saicv_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    _lib = cdll
    return _lib


def linked_libjpeg():
    """(path, version) of the libjpeg that the loaded core calls, and the
    version string libjpeg-turbo keeps in it (None where there is none)."""
    path = os.path.realpath(_file_of(lib()))
    match = re.search(rb"libjpeg-turbo version ([\d.]+)",
                      Path(path).read_bytes())
    return path, match.group(1).decode() if match else None
