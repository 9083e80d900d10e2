"""Packaging of the port: an installed copy must carry every kernel source
and header and the host C++ source of the PLY unpack, since they are built
at first use (`ops/cuda/build.py` reads `csrc/` from the package
directory)."""

import fnmatch
import os
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "gaussian_splatting_web_tpu_torch"


def test_every_kernel_source_is_package_data():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][PKG]
    csrc = os.path.join(REPO, PKG, "csrc")
    files = sorted(os.path.relpath(os.path.join(d, n), os.path.join(REPO, PKG))
                   for d, _, names in os.walk(csrc) for n in names)
    assert any(f.endswith(".cu") for f in files)
    assert any(f.endswith(".cuh") for f in files)
    assert any(f.endswith(".cpp") for f in files)      # the PLY unpack
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, f"not shipped as package data: {missing}"
