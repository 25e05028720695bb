"""Persistent kernel cache — one knob, every process tier.

Ported from ``hpbandster_tpu/utils/compile_cache.py``. The only compile
artefacts the port can persist are the ``nvcc`` libraries of ``csrc/``
(``ops/_build.py``): a CUDA graph cannot be saved across processes, so the
graphs stay per process. With the cache, the second process on a machine
loads the libraries the first one built and runs no compiler. Every startup
path that is about to launch kernels calls
:func:`enable_persistent_compile_cache`, as the reference's do; the build
follows the same knobs whether or not it was called.

Knobs (the reference's, governing the kernel libraries here):

* ``HPB_XLA_CACHE=0`` disables the cache (e.g. hermetic CI): the libraries
  build into a private temporary directory of this process, made at its
  first build and removed at exit, so the next process builds again;
* ``HPB_XLA_CACHE_DIR`` overrides the directory.

An explicit ``cache_dir`` comes first, then ``HPB_XLA_CACHE_DIR``, then the
default: ``<checkout>/build/torch_kernels`` in a source checkout (the
package's parent holds ``setup.py``), else
``~/.cache/hpbandster_tpu_torch_kernels``, so an installed package never
writes beside itself.

An unwritable directory degrades to the private directory with one
warning: the kernels still build and launch, only their persistence is
lost. A missing ``nvcc`` or a failed compile still raises (``ops/_build.py``).
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Optional

__all__ = ["enable_persistent_compile_cache"]

_PACKAGE = Path(__file__).resolve().parent.parent
_LOG = logging.getLogger("hpbandster_tpu_torch.compile_cache")
_LOCK = threading.Lock()

#: the last directory passed explicitly; it holds for the rest of the process
_explicit: str = ""
#: the directory last made and found writable
_enabled_dir: str = ""
#: the directory last warned about as unwritable
_warned_dir: str = ""
#: this process's private build directory, made at its first use
_private: Optional[str] = None


def default_cache_dir(package: Path = _PACKAGE) -> str:
    """``<checkout>/build/torch_kernels`` when ``package`` sits in a source
    checkout, else ``~/.cache/hpbandster_tpu_torch_kernels``."""
    root = package.parent
    if (root / "setup.py").is_file():
        return str(root / "build" / "torch_kernels")
    return os.path.expanduser("~/.cache/hpbandster_tpu_torch_kernels")


def _resolve(package: Path) -> str:
    """The shared directory in use, '' when disabled or unwritable."""
    global _enabled_dir, _warned_dir
    if os.environ.get("HPB_XLA_CACHE", "") == "0":
        return ""
    cache_dir = (
        _explicit
        or os.environ.get("HPB_XLA_CACHE_DIR", "")
        or default_cache_dir(package)
    )
    with _LOCK:
        if _enabled_dir == cache_dir:
            return cache_dir
        try:
            os.makedirs(cache_dir, exist_ok=True)
            # an existing directory may still refuse writes (a read-only
            # site-packages): probe the way a build writes
            fd, probe = tempfile.mkstemp(prefix=".probe-", dir=cache_dir)
            os.close(fd)
            os.unlink(probe)
        except OSError as e:
            if _warned_dir != cache_dir:
                _warned_dir = cache_dir
                _LOG.warning(
                    "kernel cache directory %s is not writable (%s): the "
                    "kernels build into a private directory of this process",
                    cache_dir, e,
                )
            return ""
        _enabled_dir = cache_dir
    return cache_dir


def _remove_private() -> None:
    global _private
    with _LOCK:
        if _private is not None:
            shutil.rmtree(_private, ignore_errors=True)
            _private = None


def private_dir() -> Path:
    """This process's private build directory, made at the first call and
    removed at exit."""
    global _private
    with _LOCK:
        if _private is None:
            _private = tempfile.mkdtemp(prefix="hpbandster_tpu_torch_kernels-")
            atexit.register(_remove_private)
        return Path(_private)


def kernel_dir(package: Path = _PACKAGE) -> Path:
    """The directory the next library of ``package`` builds into: the shared
    one, or the private one when the cache is disabled or unwritable."""
    shared = _resolve(package)
    return Path(shared) if shared else private_dir()


def enable_persistent_compile_cache(cache_dir: str = "") -> str:
    """Point the kernel libraries' builds at a shared directory.

    Returns the directory in use ('' when disabled or unwritable). Safe to
    call from any tier, any number of times: a directory already in use is a
    lookup, and another directory takes effect for the next library this
    process loads. It builds nothing; a kernel still builds at its first
    launch.
    """
    global _explicit
    if cache_dir:
        _explicit = cache_dir
    return _resolve(_PACKAGE)
