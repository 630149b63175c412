"""The port's kernel build and binding, as far as a machine without nvcc and
without a card can check them: library naming, the missing-compiler error,
launch counters, and the note each CUDA source opens with."""
import importlib.util
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build

TPU_KERNELS = {
    "ns_update": "src/repro/kernels/ns_update/ns_update.py::ns_update",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py::flash_attention",
    "paged_attention":
        "src/repro/kernels/flash_attention/paged_attention.py::paged_attention",
    "gla_scan": "src/repro/kernels/gla_scan/gla_scan.py::gla_scan",
    # the backwards of the port's flash and gla_scan kernels (the TPU kernels have none)
    "flash_attention_bwd":
        "src/repro/kernels/flash_attention/flash_attention.py::flash_attention",
    "gla_scan_bwd": "src/repro/kernels/gla_scan/gla_scan.py::gla_scan",
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


def _script(name):
    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["tail tile dropped", "causal limit one tile short",
                                   "diagonal mask leaks one key", "late rows leak one key"])
def test_fault_check_plants_each_fault_in_the_kernel_source(fault):
    """scripts/flash_fault_check.py replaces text of csrc/flash_attention.cu; each
    target must occur exactly once, or the script errors or checks nothing."""
    old, new = _script("flash_fault_check").FAULTS[fault]
    src = Path(build.CSRC, "flash_attention.cu").read_text()
    assert src.count(old) == 1 and new != old


def test_bf16_flash_kernel_is_tma_and_wgmma():
    """Both products of the bf16 kernel are wgmma, its tiles arrive by TMA on
    mbarriers, and no mma.sync is left in the source."""
    src = Path(build.CSRC, "flash_attention.cu").read_text()
    asm = re.sub(r'"\s*"', "", src)   # adjacent string literals joined
    assert "cp.async.bulk.tensor" in asm and "mbarrier::complete_tx" in asm
    # S = Q K^T: both operands by descriptor; O += P V: A from four registers
    assert re.search(r"m64n128k16\.f32\.bf16\.bf16 \{[^}]*\}, %\d+, %\d+,", asm)
    four_regs = r"\{%\d+, %\d+, %\d+, %\d+\}"
    for hd in (64, 80, 128):
        assert re.search(rf"m64n{hd}k16\.f32\.bf16\.bf16 \{{[^}}]*\}}, {four_regs}", asm)
    assert "mma.sync" not in src and "setmaxnreg" in src


def test_bf16_flash_backward_is_tma_and_wgmma():
    """Both passes of the bf16 backward take their tiles by TMA on mbarriers
    (and the rows' lse and D by 1-d bulk copies), compute every product with
    wgmma (S and dP from shared memory or with K, V as register A operands;
    dQ, dV, dK with P or dS as register A operands over an MN-major B, N the
    head dim: 64, 80 or 128), and no mma.sync is left in the source. hd 80's
    160-byte rows are cut into 32-byte chunks under the 32-byte swizzle, hd
    64's and 128's into 128-byte ones under the 128-byte swizzle; bf16 at
    every head dim dispatches to the tensor-core launcher, f32 to the CUDA
    cores."""
    src = Path(build.CSRC, "flash_attention_bwd.cu").read_text()
    asm = re.sub(r'"(?:\s|\\)*"', "", src)   # adjacent literals joined, in macros too
    assert "cp.async.bulk.tensor.4d" in asm and "mbarrier::complete_tx" in asm
    assert "cp.async.bulk.shared::cluster.global" in asm and "mbarrier.try_wait" in asm
    four_regs = r"\{%\d+, %\d+, %\d+, %\d+\}"
    # S, dP: m64n64k16 with both operands by descriptor, or A in registers
    assert re.search(r"m64n64k16\.f32\.bf16\.bf16 \{[^}]*\}, %\d+, %\d+, p, 1, 1, 0, 0;", asm)
    assert re.search(rf"m64n64k16\.f32\.bf16\.bf16 \{{[^}}]*\}}, {four_regs}, %\d+, p, 1, 1, 0;",
                     asm)
    # dQ, dV, dK: m64n{hd}k16, A in registers, B transposed (MN-major)
    for hd in (64, 80, 128):
        assert re.search(rf"m64n{hd}k16\.f32\.bf16\.bf16 \{{[^}}]*\}}, {four_regs}, %\d+, "
                         r"p, 1, 1, 1;", asm), hd
    assert "CU_TENSOR_MAP_SWIZZLE_32B" in src and "CU_TENSOR_MAP_SWIZZLE_128B" in src
    assert "mma.sync" not in src and "setmaxnreg" in src and "ldmatrix" in src
    # the dispatch: f32 to launch_cores, bf16 to launch_wgmma, at each head dim
    entry = src[src.index('extern "C" int flash_attention_bwd('):]
    cores, wgmma = entry.split("} else {", 1)
    for hd in (64, 80, 128):
        assert f"REPRO_BWD_CASE({hd}, launch_cores)" in cores.split("if (dtype == 0) {")[1]
        assert f"REPRO_BWD_CASE({hd}, launch_wgmma)" in wgmma
    assert "__nv_bfloat16" not in src[src.index("int launch_cores("):src.index("}  // namespace")]


def test_flash_variants_apply_to_the_kernel_source():
    """scripts/flash_variants.py edits csrc/flash_attention.cu by text; every
    variant's targets occur exactly once, and each variant changes the text."""
    variants = _script("flash_variants").sources()
    base = variants.pop("kernel")
    assert base == Path(build.CSRC, "flash_attention.cu").read_text()
    assert variants and all(text != base for text in variants.values())


def test_gla_scan_bf16_kernel_is_sub_chunked_on_the_tensor_cores():
    """The bf16 kernel's four products are mma.sync m16n8k16 bf16 with f32
    sums, its fragments come through ldmatrix, and the C entry point selects
    it by type and shape alone (no launch is retried on the other kernel)."""
    src = Path(build.CSRC, "gla_scan.cu").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    rule = src[src.index("bool uses_mma("):].split("}")[0]
    for term in ("qkv_dtype == 1", "dk % 16 == 0", "dv % 16 == 0", "dk <= 128", "dv <= 128",
                 "c == 16 || c == 32 || c == 64"):
        assert term in rule
    entry = src[src.index('extern "C" int gla_scan_fwd('):]
    assert entry.count("launch_mma<") == 2 and "if (uses_mma(" in entry


def test_gla_scan_bwd_bf16_kernel_is_sub_chunked_on_the_tensor_cores():
    """The backward's bf16 kernel runs its products as mma.sync m16n8k16 bf16
    with f32 sums on ldmatrix fragments; it is chosen by the forward's rule
    (type and shape alone, no launch retried on the other kernel); and no
    sum goes through an atomic, so two runs give the same bits."""
    src = Path(build.CSRC, "gla_scan_bwd.cu").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    rule = src[src.index("bool uses_mma("):].split("}")[0]
    for term in ("qkv_dtype == 1", "dk % 16 == 0", "dv % 16 == 0", "dk <= 128", "dv <= 128",
                 "c == 16 || c == 32 || c == 64"):
        assert term in rule
    entry = src[src.index('extern "C" int gla_scan_bwd('):]
    assert entry.count("launch_mma(") == 1 and "if (uses_mma(" in entry
    assert entry.index("if (uses_mma(") < entry.index("launch_mma(") < entry.index("launch<")
    assert 'extern "C" int gla_scan_bwd_uses_mma(' in src
    assert "atomicAdd" not in src and not re.search(r"\b(atom|red)\.", src)


GLA_BWD_FAULTS = ["diagonal mask off by one", "a lo part dropped",
                  "a reference point moved by a row", "dld's carry dropped"]


@pytest.mark.parametrize("fault", GLA_BWD_FAULTS)
def test_gla_bwd_fault_check_plants_each_fault_in_the_kernel_source(fault):
    """scripts/gla_bwd_fault_check.py replaces text of csrc/gla_scan_bwd.cu;
    each target must occur exactly once, or the script errors or checks
    nothing."""
    mod = _script("gla_bwd_fault_check")
    assert sorted(mod.FAULTS) == sorted(GLA_BWD_FAULTS)
    old, new = mod.FAULTS[fault]
    src = Path(build.CSRC, "gla_scan_bwd.cu").read_text()
    assert src.count(old) == 1 and new != old


PAGED_FAULTS = ["merge drops the last split", "merge skips the rescale",
                "reads one position past the length", "split boundary moved by one"]


@pytest.mark.parametrize("fault", PAGED_FAULTS)
def test_paged_fault_check_plants_each_fault_in_the_kernel_source(fault):
    """scripts/paged_fault_check.py replaces text of csrc/paged_attention.cu;
    each target must occur exactly once, or the script errors or checks
    nothing."""
    old, new = _script("paged_fault_check").FAULTS[fault]
    src = Path(build.CSRC, "paged_attention.cu").read_text()
    assert src.count(old) == 1 and new != old


def test_paged_attention_kernel_is_split_staged_and_merged_in_one_launch():
    """The grid carries splits of a row's pages; each block stages its tiles
    through a cp.async ring of at least 3 stages (zero-filling past the
    split's end); the last split to arrive at a (row, head)'s counter merges
    the partials and resets the counter, all in the one launch."""
    src = Path(build.CSRC, "paged_attention.cu").read_text()
    stages = re.search(r"kStages = sizeof\(TP\) == 4 \? (\d+) : (\d+);", src)
    assert stages and min(int(stages[1]), int(stages[2])) >= 3
    assert 'cp.async.cg.shared.global [%0], [%1], 16, %2;' in src      # src-size: zfill
    assert "cp.async.commit_group" in src and "cp.async.wait_group %0" in src
    assert "const dim3 grid((unsigned)(a.nsplit * a.KV), (unsigned)a.B);" in src
    assert "if (split >= live) return;" in src
    merge = src[src.index("several live splits: publish"):src.index("struct Args {")]
    assert "last_sm = arrive(&counters[bh]) == live - 1" in merge
    assert "atom.acq_rel.gpu.global.add.s32" in src
    assert "counters[bh] = 0;" in merge and "__ldcg(" in merge
    assert src.count("<<<") == 1                                      # one launch a call
    # bf16 q over bf16 pages: both products on the tensor cores
    assert "constexpr bool MMA = sizeof(TQ) == 2 && sizeof(TP) == 2;" in src
    assert src.count("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32") == 1
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src


def test_paged_attention_binding_matches_the_c_signature():
    """The ctypes argument types the wrapper sets follow the C entry point's
    parameters: int -> c_int, pointers -> c_void_p, float -> c_float."""
    import ctypes

    from repro_torch.kernels.flash_attention import paged_attention as pa_mod

    src = Path(build.CSRC, "paged_attention.cu").read_text()
    sig = src[src.index('extern "C" int paged_attention_fwd('):].split(")")[0]
    params = [p.strip() for p in sig.split("(", 1)[1].split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float ")
            else ctypes.c_int for p in params]

    class Lib:
        paged_attention_fwd = type("Fn", (), {"argtypes": None, "restype": None})()

    _, fn = pa_mod.bind(Lib())
    assert fn.argtypes == want and fn.restype is ctypes.c_int


def test_paged_variants_apply_to_the_kernel_source():
    """scripts/paged_variants.py edits csrc/paged_attention.cu by text; every
    variant's targets occur exactly once, and each variant changes the text."""
    variants = _script("paged_variants").sources()
    base = variants.pop("kernel")
    assert base == Path(build.CSRC, "paged_attention.cu").read_text()
    assert variants and all(text != base for text in variants.values())


def test_ns_update_bwd_variants_apply_to_the_kernel_source():
    """scripts/ns_update_bwd_variants.py edits csrc/ns_update.cu by text; every
    variant's target occurs exactly once, and each variant changes the text."""
    base = Path(build.CSRC, "ns_update.cu").read_text()
    variants = _script("ns_update_bwd_variants").sources(None)
    assert set(variants) == set(_script("ns_update_bwd_variants").VARIANTS)
    assert all(text != base for text in variants.values())


def test_ns_update_bwd_kernel_holds_g_and_sums_in_a_fixed_order():
    """The backward walks the rows inside its element loop with g in registers,
    several rows' loads issued together, and adds the blocks' partials one warp
    a dot product in lane order, then a shuffle tree: no float atomics."""
    src = Path(build.CSRC, "ns_update.cu").read_text()
    kernel = src[src.index("ns_update_bwd_kernel("):src.index("int launch_bwd(")]
    assert "float gf[P][V];" in kernel and "float sf[R][P][V];" in kernel
    assert kernel.index("load16(g + ") < kernel.index("for (int j0 = 0; j0 <= n; j0 += R)")
    assert "for (int blk = lane; blk < blocks; blk += 32)" in kernel
    assert "atomicAdd" not in src and "red.global.add.f32" not in src


def test_flash_bwd_variants_apply_to_the_kernel_source():
    """scripts/flash_bwd_variants.py edits csrc/flash_attention_bwd.cu by
    text; each variant's targets occur as often as it states, and each
    variant changes the text."""
    variants = _script("flash_bwd_variants").sources()
    base = variants.pop("kernel")
    assert base == Path(build.CSRC, "flash_attention_bwd.cu").read_text()
    assert variants and all(text != base for text in variants.values())


@pytest.mark.parametrize("fault", ["D term dropped", "one head of the group missing from dK/dV",
                                   "causal limit one tile short", "last key tile dropped",
                                   "scale missing on dK"])
def test_flash_bwd_fault_check_plants_each_fault_in_the_kernel_source(fault):
    """scripts/flash_bwd_fault_check.py edits csrc/flash_attention_bwd.cu by
    text; each target occurs exactly once and each fault changes the text."""
    mod = _script("flash_bwd_fault_check")
    src = Path(build.CSRC, "flash_attention_bwd.cu").read_text()
    for old, new in mod.FAULTS[fault]:
        assert src.count(old) == 1 and new != old
    assert mod.fault_sources()[fault] != src


def _c_params(source: str, entry: str) -> list[str]:
    src = Path(build.CSRC, source).read_text()
    sig = src[src.index(f'extern "C" int {entry}('):].split(")")[0]
    return [p.strip() for p in sig.split("(", 1)[1].split(",")]


def _ctypes_of(params):
    import ctypes

    return [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float ")
            else ctypes.c_longlong if p.startswith("long long") else ctypes.c_int
            for p in params]


class _FakeFn:
    def __init__(self):
        self.argtypes = self.restype = None


def test_backward_bindings_match_the_c_signatures(monkeypatch):
    """The ctypes argument types the wrappers set follow the C entry points'
    parameters, for the flash forward (with its lse pointer), the flash
    backward (with its dk/dv flag), the ns_update backward and the gla_scan
    backward (and its kernel rule)."""
    import ctypes

    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.gla_scan import gla_scan as gs_mod
    from repro_torch.kernels.ns_update import ns_update as nu_mod

    class Lib:
        flash_attention_fwd = _FakeFn()
        flash_attention_bwd = _FakeFn()
        ns_update_fwd = _FakeFn()
        ns_update_bwd = _FakeFn()
        ns_update_bwd_max_blocks = _FakeFn()
        gla_scan_bwd = _FakeFn()
        gla_scan_bwd_smem_bytes = _FakeFn()
        gla_scan_bwd_uses_mma = _FakeFn()

    lib = Lib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(nu_mod, "_BOUND", None)
    fa_mod._lib()
    fa_mod._bwd_lib()
    nu_mod._entry()
    gs_mod._bwd_lib()
    for entry, source in (("flash_attention_fwd", "flash_attention.cu"),
                          ("flash_attention_bwd", "flash_attention_bwd.cu"),
                          ("ns_update_fwd", "ns_update.cu"),
                          ("ns_update_bwd", "ns_update.cu"),
                          ("gla_scan_bwd", "gla_scan_bwd.cu"),
                          ("gla_scan_bwd_uses_mma", "gla_scan_bwd.cu")):
        fn = getattr(lib, entry)
        assert fn.argtypes == _ctypes_of(_c_params(source, entry)), entry
        assert fn.restype is ctypes.c_int


def test_flash_backward_kernel_is_two_passes_without_atomics():
    """dq (with D) then dk/dv, one block a tile, no atomics: deterministic."""
    src = Path(build.CSRC, "flash_attention_bwd.cu").read_text()
    for kernel in ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_wgmma_kernel",
                   "flash_bwd_dkdv_wgmma_kernel"):
        assert f"{kernel}(" in src
    # no atomic function and no PTX atomic or reduction opcode (as a whole
    # token, so prose such as "stored." does not count)
    assert "atomicAdd" not in src and not re.search(r"\b(atom|red)\.", src)
    wgmma = src[src.index("int launch_wgmma("):src.index("int launch_cores(")]
    cores = src[src.index("int launch_cores("):]
    for launcher, second in ((wgmma, "kv_kern<<<"), (cores, "dkdv_kern<<<")):
        assert launcher.count("<<<") == 2 and launcher.index("dq_kern<<<") < launcher.index(second)
