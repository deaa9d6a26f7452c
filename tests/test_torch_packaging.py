"""An installed port carries every source its build functions read: each file
``rtvc_tpu_torch/_build.py`` compiles (the CUDA kernels under ``csrc/``, the
codec shim's C source, the WaveRNN engine's C++ sources and header) matches
a ``[tool.setuptools.package-data]`` glob of ``rtvc_tpu_torch`` in
``pyproject.toml``. No wheel is built: the globs are read with ``tomllib``
and matched as setuptools matches them, relative to the package."""
import glob
import tomllib
from pathlib import Path

import pytest

from rtvc_tpu_torch import _build

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "rtvc_tpu_torch"


def package_data():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]["rtvc_tpu_torch"]


def shipped() -> set:
    """The files of the package that its package-data globs select."""
    return {Path(p).resolve() for pattern in package_data()
            for p in glob.glob(str(PKG / pattern))}


def build_sources():
    cu, cuh = _build._sources()
    engine = [_build.ENGINE_SRC_DIR / name for name in _build.ENGINE_SOURCES]
    return [*cu, *cuh, _build.CODEC_SRC, *engine]


@pytest.mark.parametrize("path", build_sources(), ids=lambda p: str(p.relative_to(PKG)))
def test_every_source_the_build_reads_ships_with_the_package(path):
    assert path.is_file()
    assert path.resolve() in shipped(), f"{path.relative_to(PKG)} matches no package-data glob"


def test_the_build_reads_the_kernels_the_codec_and_the_engine():
    names = {p.relative_to(PKG).as_posix() for p in build_sources()}
    assert {"native/src/audio_codec.c", "native/src/wavernn_engine.cpp",
            "native/src/wavernn_engine.h", "native/src/vocoder_cli.cpp",
            "csrc/common.cuh", "csrc/lstm_seq.cu", "csrc/lstm_seq_mma.cu"} <= names
    assert len([n for n in names if n.endswith(".cu")]) == 7
