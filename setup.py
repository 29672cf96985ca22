"""Wheel/sdist build: bundles the native host extension into the package.

`make native` remains the fast in-repo build (drops the .so into
panvc3_tpu/native_build/ without packaging); this setup.py gives
`make dist` / `pip wheel .` a distributable artifact with the same
extension built in — the analogue of the reference's conda package +
`make dist` portable tarball (/root/reference/conda/meta.yaml,
/root/reference/Makefile:108-119).

PANVC3_MARCH overrides the -march flag (default `native`; set e.g.
`x86-64-v3` for a portable wheel).  -ffp-contract=off is load-bearing:
the C extended-P² estimator must round exactly like the float64 oracle
(see native/setup.py and tests/test_aux_tools.py).

The PyTorch/CUDA port (panvc3_tpu_torch) ships no prebuilt library: its
build_py step copies native/*.c and *.h into the built package
(panvc3_tpu_torch/_native_src/), which an installed port compiles at
first use on the machine that runs it, as it does its CUDA sources.
"""

import os
import pathlib
import sys

from setuptools import Extension, setup
from setuptools.command.build_py import build_py

_march = os.environ.get("PANVC3_MARCH", "native")
_ROOT = pathlib.Path(__file__).resolve().parent


class BuildPyWithPortSources(build_py):
    """build_py, then the port's copy of the C sources."""

    def run(self):
        super().run()
        sys.path.insert(0, str(_ROOT))
        from panvc3_tpu_torch.native import STAGED_DIR, stage_sources

        stage_sources(
            _ROOT / "native",
            pathlib.Path(self.build_lib) / "panvc3_tpu_torch" / STAGED_DIR.name,
        )


setup(
    cmdclass={"build_py": BuildPyWithPortSources},
    ext_modules=[
        Extension(
            # lands inside the package so the wheel carries it; the
            # loader (panvc3_tpu/native.py) imports it top-level from
            # the native_build dir, which works for both layouts
            "panvc3_tpu.native_build._panvc3_native",
            sources=[
                "native/panvc3_native.c",
                "native/fastpath.c",
                "native/bgzf.c",
                "native/csr.c",
                "native/als.c",
            ],
            libraries=["z"],
            extra_compile_args=[
                "-O3", f"-march={_march}", "-pthread", "-ffp-contract=off",
            ],
            extra_link_args=["-pthread"],
        )
    ],
)
