"""Native host-runtime helpers (C extension), built lazily with the system
compiler into zksnake_tpu_torch/_build/; everything degrades to the
pure-Python paths when unavailable."""

import os
import subprocess
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")


def _build():
    src = os.path.join(_DIR, "limbcodec.c")
    ext_suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(_BUILD_DIR, "_limbcodec" + ext_suffix)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    include = sysconfig.get_paths()["include"]
    cmd = [
        os.environ.get("CC", "cc"),
        "-O2",
        "-shared",
        "-fPIC",
        f"-I{include}",
        src,
        "-o",
        tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)  # atomic: a concurrent import never loads a partial file
    return out


_codec = None
_tried = False


def get_codec():
    """Returns the _limbcodec module, building it on first use; None if the
    toolchain is unavailable (callers fall back to pure Python)."""
    global _codec, _tried
    if _codec is None and not _tried:
        _tried = True
        if os.environ.get("ZKSNAKE_NO_NATIVE", "0") == "1":
            return None
        try:
            path = _build()
            import importlib.util

            spec = importlib.util.spec_from_file_location("_limbcodec", path)
            _codec = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(_codec)
            # self-check
            assert _codec.bytes_to_ints(_codec.ints_to_bytes([5, 7], 8), 8) == [5, 7]
        except Exception:
            _codec = None
    return _codec
