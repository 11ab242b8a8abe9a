"""Build the native map core: python -m pyorbslam_jax.native.build"""

import os
import subprocess
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "mapcore.cpp")
OUT = os.path.join(HERE, "libmapcore.so")


def build(verbose: bool = True) -> str:
    """Compile ``mapcore.cpp`` into ``libmapcore.so`` beside it.

    The library is written to a temporary name and renamed into place, so
    processes that build at the same time (test workers) never load a
    half-written file.  No ``-march=native``: a checkout copied to another
    host must not carry a binary built for this host's CPU.
    """
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=".libmapcore.", dir=HERE)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, OUT)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return OUT


if __name__ == "__main__":
    build()
    print(f"built {OUT}")
