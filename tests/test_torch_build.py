"""The port's kernel build helpers (``repro_torch/kernels/_build.py``) on
the CPU: the library key over a family's sources, and the readers of the
compiler's register report and of the SASS, which ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` use on the card to show which kernels run
on the tensor cores."""
import shutil

import pytest

from repro_torch.kernels import _build

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN9flash_mma13flash_fwd_mmaILi64ELb1EEEvPKc' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_mma13flash_fwd_mmaILi64ELb1EEEvPKc
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 436 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19flash_fwdIfLi32ELb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19flash_fwdIfLi32ELb0EEEvPKf
    16 bytes stack frame, 16 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 2048 bytes smem, 436 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN9flash_mma12flash_dq_mmaILi64EEEvPKc
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
        /*0010*/                   LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR4][R4.64] ;  /* 0x0000000004037fae */
        /*0020*/                   HMMA.16816.F32.BF16 R20, R4, R16, R20 ;   /* 0x000000100414723c */
        /*0030*/              @!P0 HMMA.16816.F32.BF16 R24, R4, R18, R24 ;   /* 0x000000120418723c */
        /*0040*/                   LDSM.16.M88.4 R8, [R2] ;          /* 0x000000000208783b */
\t\tFunction : _ZN12_GLOBAL__N_112flash_bwd_dqIfLi64EEEvPKf
        /*0000*/                   FFMA R2, R3, R4, R2 ;             /* 0x0000000403027223 */
        /*0010*/                   EXIT ;                            /* 0x000000000000794d */
"""


def test_parse_ptxas_reads_each_kernel():
    rep = _build.parse_ptxas(PTXAS_LOG)
    assert rep == {
        "_ZN9flash_mma13flash_fwd_mmaILi64ELb1EEEvPKc": dict(
            registers=168, spill_stores=0, spill_loads=0, stack=0, smem=0),
        "_ZN12_GLOBAL__N_19flash_fwdIfLi32ELb0EEEvPKf": dict(
            registers=128, spill_stores=16, spill_loads=48, stack=16,
            smem=2048)}


def test_parse_sass_counts_opcodes_per_kernel():
    counts = _build.parse_sass(SASS)
    assert counts == {
        "_ZN9flash_mma12flash_dq_mmaILi64EEEvPKc": {"HMMA": 2, "LDGSTS": 1},
        "_ZN12_GLOBAL__N_112flash_bwd_dqIfLi64EEEvPKf": {"HMMA": 0,
                                                         "LDGSTS": 0}}
    assert _build.parse_sass(SASS, ops=("LDSM",))[
        "_ZN9flash_mma12flash_dq_mmaILi64EEEvPKc"] == {"LDSM": 1}


def test_header_is_not_a_library_but_keys_one(tmp_path, monkeypatch):
    """A ``.cuh`` beside a source builds no library of its own, and an edit
    to it rebuilds the family's library (the key hashes every
    ``csrc/*.cu*``)."""
    assert "flash_mma" not in _build.sources()
    assert "flash_attention" in _build.sources()
    fam = tmp_path / "fam" / "csrc"
    fam.mkdir(parents=True)
    (fam / "k.cu").write_text('#include "k.cuh"\n')
    (fam / "k.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    assert list(_build.sources()) == ["k"]
    before = _build.target("k")
    (fam / "k.cuh").write_text("// two\n")
    assert _build.target("k") != before
    (fam / "k.cuh").write_text("// one\n")
    assert _build.target("k") == before


def test_sass_counts_needs_cuobjdump(monkeypatch):
    """Without the CUDA toolkit there is no SASS to read: a clear error,
    not an empty count."""
    monkeypatch.setattr(_build, "_tool", lambda name: None)
    with pytest.raises(RuntimeError, match="cuobjdump"):
        _build.sass_counts("flash_attention")


def test_demangle_keeps_names_without_a_demangler(monkeypatch):
    monkeypatch.setattr(_build, "_tool", lambda name: None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    names = ["_ZN9flash_mma12flash_dq_mmaILi64EEEvPKc"]
    assert _build.demangle(names) == {names[0]: names[0]}
