"""The port's kernel build and binding, as far as a machine without nvcc and
without a card can check them: library naming, the missing-compiler error,
launch counters, and the note each CUDA source opens with."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build

TPU_KERNELS = {
    "ns_update": "src/repro/kernels/ns_update/ns_update.py::ns_update",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py::flash_attention",
}


def test_every_source_is_built():
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(build.SOURCES)


def test_library_lands_in_the_ignored_build_dir_named_by_content(tmp_path, monkeypatch):
    path = build.library_path("ns_update")
    assert path.parent == build.BUILD_DIR and path.parts[-3:-1] == ("build", "repro_torch")
    assert re.fullmatch(r"libns_update-[0-9a-f]{12}\.so", path.name)
    assert build.library_path("ns_update") == path
    src = tmp_path / "ns_update.cu"
    src.write_text(build.CSRC.joinpath("ns_update.cu").read_text() + "\n// edited\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("ns_update") != path


def test_missing_nvcc_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_launch_counter():
    c = build.LaunchCounter("k")
    c.launches += 3
    c.reset()
    assert (c.name, c.launches) == ("k", 0)


@pytest.mark.parametrize("name", sorted(TPU_KERNELS))
def test_source_opens_with_its_note(name):
    """Which TPU kernel it replaces, what bounds it, what its design does."""
    head = Path(build.CSRC, f"{name}.cu").read_text().split("#include")[0]
    text = " ".join(line.lstrip("/ ") for line in head.splitlines())
    assert f"Replaces the TPU kernel {TPU_KERNELS[name]}" in text
    assert "What bounds it" in text and "What the design does about it" in text
