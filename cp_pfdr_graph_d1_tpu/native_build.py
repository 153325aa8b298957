"""Builds the host C++ libraries from their committed sources at first use.

Each library lands in ``<checkout>/.native_build/<name>-<key>.so``, where
the key hashes the compiler flags and the sources' contents: a checkout
never loads a binary built from other sources, whatever the files' times
say.  The flags target the generic x86-64/aarch64 baseline, so a library
built on one host runs on any other.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import tempfile

BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / ".native_build"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path(name: str, sources) -> pathlib.Path:
    """Where the library built from ``sources`` lives (built or not)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        h.update(pathlib.Path(src).name.encode())
        h.update(pathlib.Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources) -> pathlib.Path:
    """Returns the path of the library built from ``sources``, compiling it
    with ``g++`` first when no build of these exact sources exists.
    Concurrent builders each compile to a private file and rename it into
    place, so a reader never sees a partial library."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-",
                               suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp,
                        *(str(s) for s in sources)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
