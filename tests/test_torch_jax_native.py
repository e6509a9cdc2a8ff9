"""The JAX package's native library, for the port's tests that compare with it.

The JAX package builds its gitignored ``libdfprior_native.so`` the first
time something asks for it (``make -C`` with no lock) and reports it
unavailable for good once a build fails
(``attentive_dfprior_tpu/native/__init__.py``). Test workers that start
that build at once can leave one of them without it, and a test that
compares with it would then skip or compare two routes. The ``jax_native``
fixture gives a test the JAX module with a library loaded, whatever this
worker's build did: where ``available()`` is false it compiles the
package's two sources with its Makefile's flags into pytest's tmp
directory, reading them only, and points the module at the result for the
test (``monkeypatch``). Nothing is written into the JAX package.

Held here: with the package's own build failing (its library missing and a
``make`` that exits 1), the fixture's library loads and meshes a sphere as
the JAX package's numpy route does, and the package's directory is left as
it was.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import pytest

from test_torch_imports import REPO

JAX_NATIVE_DIR = os.path.join(REPO, "attentive_dfprior_tpu", "native")
JAX_NATIVE_SOURCES = ("rasterizer.cpp", "marching_tets.cpp")
MAKE_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-march=native", "-Wall", "-shared")  # its Makefile's


@pytest.fixture(scope="session")
def jax_native_build(tmp_path_factory) -> str:
    """The JAX package's library compiled once a worker; its path."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the JAX package's native library cannot be built here")
    out = tmp_path_factory.mktemp("jax_native") / "libdfprior_native.so"
    srcs = [os.path.join(JAX_NATIVE_DIR, f) for f in JAX_NATIVE_SOURCES]
    subprocess.run(["g++", *MAKE_FLAGS, "-o", str(out), *srcs], check=True, capture_output=True, timeout=600)
    return str(out)


def load_jax_native(request, monkeypatch):
    """The JAX ``native`` module with a library loaded: its own, or where
    that is unavailable in this worker, ``jax_native_build``'s."""
    from attentive_dfprior_tpu import native

    if not native.available():
        monkeypatch.setattr(native, "_LIB_PATH", request.getfixturevalue("jax_native_build"))
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_build_failed", False)
        if not native.available():
            raise RuntimeError(f"the JAX package's native library built at {native._LIB_PATH} does not load")
    return native


@pytest.fixture
def jax_native(request, monkeypatch):
    return load_jax_native(request, monkeypatch)


def jax_native_off(monkeypatch) -> None:
    """Make the JAX package's native library unavailable for the test: its
    callers take their numpy routes."""
    from attentive_dfprior_tpu import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)


def test_library_loads_when_the_package_build_fails(request, monkeypatch, tmp_path):
    from attentive_dfprior_tpu import native
    from attentive_dfprior_tpu.utils.marching_cubes import marching_cubes_numpy

    listing = sorted(os.listdir(JAX_NATIVE_DIR))
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "make").write_text("#!/bin/sh\nexit 1\n")
    (fake / "make").chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "missing" / "libdfprior_native.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    assert not native.available()  # the package's own build failed

    missing = native._LIB_PATH
    assert load_jax_native(request, monkeypatch) is native
    assert native.available() and native._LIB_PATH != missing
    g = np.mgrid[:12, :12, :12].astype(np.float64)
    vol = 4.0 - np.sqrt(((g - 5.5) ** 2).sum(0))
    v_nat, f_nat = native.marching_tets(vol, 0.0)
    v_np, f_np, _ = marching_cubes_numpy(vol, 0.0)
    assert len(f_nat) == len(f_np) > 100 and len(v_nat) == len(v_np)

    def rows(v):  # up to vertex order
        return v[np.lexsort(v.T[::-1])]

    np.testing.assert_allclose(rows(v_nat), rows(v_np), atol=1e-9)
    assert sorted(os.listdir(JAX_NATIVE_DIR)) == listing
