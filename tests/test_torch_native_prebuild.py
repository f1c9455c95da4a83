"""The JAX package's native libraries are built once, before any test
runs (tests/_native_prebuild.py), so its tests never race a `make` that
links in place: both libraries exist whole and load, and its oracle and
bank loader report themselves available.  A library that should build
here and did not fails this file with the compiler's output instead of
leaving the oracle's tests to skip."""

import ctypes
import os

import pytest

import _native_prebuild as NP


@pytest.mark.parametrize("name", sorted(NP.LIBS))
def test_library_prebuilt_and_loads(name):
    if name == "liblpe_oracle.so" and not os.path.exists(NP.RGBD_HEADER):
        assert not os.path.exists(os.path.join(NP.BUILD, name)) or name not in NP.errors
        return  # no OpenCV rgbd module on this host: the oracle's tests skip by design
    assert name not in NP.errors, NP.errors.get(name)
    ctypes.CDLL(os.path.join(NP.BUILD, name))


def test_jax_package_finds_them_without_make():
    from linemod_pose_estimation_tpu.utils import native, oracle

    assert native.available()
    assert oracle.available() == os.path.exists(NP.RGBD_HEADER)


def test_prebuild_is_idempotent():
    before = {n: os.stat(os.path.join(NP.BUILD, n)).st_mtime_ns for n in NP.LIBS
              if os.path.exists(os.path.join(NP.BUILD, n))}
    NP.prebuild()
    after = {n: os.stat(os.path.join(NP.BUILD, n)).st_mtime_ns for n in before}
    assert before == after
