"""Build the repository's C++ sources (ops/cpp/) into shared libraries.

A library is built from the committed source into the gitignored
``build/native/`` directory at the repository root, under a name keyed by a
hash of the source text, the compiler command line and the jaxlib version.
So a library is loaded only when it was built from exactly this source with
exactly these flags; a ``.so`` left on disk by another source, flag set or
host is never picked up by file times.  The flags are portable (no
``-march=native``), so a library built on one x86-64 host runs on another.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

import jaxlib

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def build_dir() -> str:
    return os.path.join(_REPO_ROOT, "build", "native")


def library_path(src: str, flags: Sequence[str]) -> str:
    """Where the library for ``src`` built with ``flags`` lives."""
    with open(src, "rb") as fh:
        text = fh.read()
    h = hashlib.sha256()
    h.update(text)
    h.update("\0".join(["g++", *flags]).encode())
    h.update(jaxlib.__version__.encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir(), f"{stem}-{h.hexdigest()[:16]}.so")


def build_shared_library(src: str, flags: Sequence[str]) -> str:
    """Compile ``src`` with ``g++ flags`` unless that exact build exists;
    return the library's path.  Raises ``subprocess.CalledProcessError`` when
    the compiler fails.  The library is written under a temporary name and
    renamed into place, so concurrent builders never load a partial file."""
    out = library_path(src, flags)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=build_dir())
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *flags, "-o", tmp, src, "-lpthread"],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
