"""Build the native host libraries from native/*.cpp at first use.

The shared objects are not committed: the first process that needs one
compiles it into native/build/ (listed in .gitignore). The compiler
writes a temporary file in that directory, which is then renamed into
place, so parallel processes (test workers, fan-out subprocesses) never
load a half-written library. A library older than its source is rebuilt.
tools/build_native.sh runs the same builds ahead of time.

The build counts as set-up time: about 8 s for the engine glue and under
1 s for the BGZF codec with g++ -O3.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO, "native", "build")

# library name -> (source, g++ flags before -o, flags after the source)
LIBS = {
    "libpansvr_bgzf.so": ("bgzf_codec.cpp", ["-O3", "-fPIC", "-shared"],
                          ["-lz", "-lpthread"]),
    "libpansvr_glue.so": ("engine_glue.cpp",
                          ["-O3", "-fPIC", "-shared", "-std=c++17",
                           "-pthread"], []),
}


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, name)


def build_command(name: str, out: str) -> list[str]:
    src, pre, post = LIBS[name]
    return (["g++"] + pre + ["-o", out, os.path.join(REPO, "native", src)]
            + post)


def ensure_built(name: str) -> str | None:
    """Path of an up-to-date native/build/<name>, compiling it when it
    is missing or older than its source. None when it cannot be built
    (no compiler, or the compile failed; the reason goes to stderr)."""
    path = lib_path(name)
    src = os.path.join(REPO, "native", LIBS[name][0])
    if os.path.exists(path) and (
            not os.path.exists(src)
            or os.path.getmtime(path) >= os.path.getmtime(src)):
        return path
    if not os.path.exists(src):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}.", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(build_command(name, tmp), capture_output=True,
                           text=True)
        if r.returncode != 0:
            print(f"[pansvr native] building {name} failed:\n"
                  f"{r.stderr[-2000:]}", file=sys.stderr)
            return None
        os.replace(tmp, path)
    except OSError as e:
        print(f"[pansvr native] building {name} failed: {e}",
              file=sys.stderr)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


if __name__ == "__main__":
    failed = [n for n in LIBS if ensure_built(n) is None]
    if failed:
        sys.exit(f"native build failed: {failed}")
    print("built " + " ".join(lib_path(n) for n in LIBS))
