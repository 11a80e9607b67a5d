"""The kernel build's digest: a library is rebuilt when a file it is
compiled from changes, and only then.

The digest of a package hashes the compiler flags, its own ``csrc/`` and
the shared ``kernels/csrc/`` (``hopper.cuh``), under a kernels directory
given as ``root``; here a copy of those directories under ``tmp_path``
stands for the tree, so nothing of the checkout is touched.
"""

import shutil

from repro_torch.kernels import _build


def _copy_tree(root):
    for package in _build.PACKAGES:
        shutil.copytree(_build._csrc(package), _build._csrc(package, root))
    shutil.copytree(_build.KERNELS / _build.SHARED, root / _build.SHARED)


def _digests(root=_build.KERNELS):
    return {package: _build._digest(package, root) for package in _build.PACKAGES}


def test_digest_depends_on_contents_not_place(tmp_path):
    _copy_tree(tmp_path)
    assert _digests(tmp_path) == _digests()


def test_shared_header_change_changes_every_digest(tmp_path):
    _copy_tree(tmp_path)
    before = _digests(tmp_path)
    header = tmp_path / _build.SHARED / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = _digests(tmp_path)
    assert all(after[p] != before[p] for p in _build.PACKAGES), (before, after)


def test_package_source_change_changes_its_digest_only(tmp_path):
    _copy_tree(tmp_path)
    before = _digests(tmp_path)
    source = _build._csrc("moe_gemm", tmp_path) / "moe_ffn.cu"
    source.write_text(source.read_text() + "\n// an edit\n")
    after = _digests(tmp_path)
    assert {p for p in _build.PACKAGES if after[p] != before[p]} == {"moe_gemm"}
