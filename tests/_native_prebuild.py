"""Build the JAX package's native libraries once per test run, before any
test runs: native/build/liblpe_native.so (the bank loader) and
native/build/liblpe_oracle.so (the cv::linemod oracle), with
native/Makefile's flags.

The JAX package builds them on first use with `make -C native`, which
links in place.  Under pytest-xdist two workers can run that make at once
(the bank loader's `all` target links the oracle too), and a worker that
loads the oracle while another is still linking it gets a truncated file,
so test_oracle_parity.py's ten tests skipped in one run and passed in the
next.  Here every xdist worker calls `prebuild()` while it collects (each
worker imports every test module then, and no test runs before every
worker has collected): under a file lock the first one compiles each
missing library to a file of its own and renames it into place, and the
others find it there.  Once the files exist the JAX package never runs
make.  `errors` holds the compiler's output for a library that did not
build.
"""

import fcntl
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")
BUILD = os.path.join(NATIVE, "build")
CXXFLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")  # native/Makefile
OPENCV = ("-I/usr/include/opencv4",)
LIBS = {
    "liblpe_native.so": ((), "bank_loader.cpp", ()),
    "liblpe_oracle.so": (OPENCV, "linemod_oracle.cpp",
                         ("-lopencv_rgbd", "-lopencv_core", "-lopencv_imgproc")),
}
RGBD_HEADER = "/usr/include/opencv4/opencv2/rgbd.hpp"

errors: dict[str, str] = {}


def prebuild() -> None:
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, ".prebuild.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for name, (pre, source, post) in LIBS.items():
            so = os.path.join(BUILD, name)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                r = subprocess.run(["g++", *CXXFLAGS, *pre, "-o", tmp,
                                    os.path.join(NATIVE, source), *post],
                                   capture_output=True, text=True, timeout=600)
                if r.returncode == 0:
                    os.replace(tmp, so)
                else:
                    errors[name] = r.stderr[-4000:]
            except (OSError, subprocess.SubprocessError) as e:
                errors[name] = repr(e)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)


prebuild()
