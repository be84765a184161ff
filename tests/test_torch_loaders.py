"""The port's reference-format loaders against the JAX package, on the CPU.

The vendored ``datasets/MM_HS35`` family, gz-pickle directories written by
either package and read by the other (dense QP, QP_RHS, and the CSC schema
of the other families, with oracle labels), the ``QPLIB`` branch on files
written here (the repository holds no QPLIB instance), the reference
directory beside a missing ``.npz``, and ``mm_vendor.write_family``.  The
loaders are the same numpy code in both packages: every array is asserted
equal.
"""

import dataclasses
import os
import pathlib

import numpy as np
import pytest

from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.problems import mm_vendor as jmm

from iadmm_tpu_torch.problems import io as tio
from iadmm_tpu_torch.problems import mm_vendor as tmm
from iadmm_tpu_torch.problems import oracle as toracle

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_same(a, b):
    assert a.prob_type == b.prob_type
    for f in dataclasses.fields(a):
        if f.name == "prob_type":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        else:
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_vendored_mm_hs35_loads_equal():
    root = str(ROOT / "datasets")
    t = tio.load_dataset(root, "MM_HS35", 3, data_size=16)
    j = jio.load_dataset(root, "MM_HS35", 3, data_size=16)
    _assert_same(t, j)
    assert t.size == 16 and t.Q.shape == (16, 3, 3) and t.A0.shape[-2] == 4
    np.testing.assert_allclose(t.x_opt[0], tmm.HS35_X_OPT, atol=2e-3)


@pytest.mark.parametrize("prob_type,n,mi,me", [
    ("QP", 10, 5, 5), ("QP_RHS", 10, 5, 5), ("Random_QP", 10, 6, 0),
    ("SVM", 8, 6, 0), ("Equality_QP", 10, 0, 4)])
def test_gz_dirs_cross_both_packages(tmp_path, prob_type, n, mi, me):
    ds = jgen.generate(prob_type, num_var=n, num_ineq=mi, num_eq=me,
                       data_size=4, seed=3)
    toracle.label_dataset(ds, eps=1e-4, backend="native")
    prefix = prob_type.lower()
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tio.save_reference_gz_dir(ds, tdir, prefix)
    jio.save_reference_gz_dir(ds, jdir, prefix)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    ids = range(4)
    _assert_same(tio.load_reference_gz_dir(jdir, prefix, ids),
                 jio.load_reference_gz_dir(jdir, prefix, ids))
    _assert_same(tio.load_reference_gz_dir(tdir, prefix, ids),
                 jio.load_reference_gz_dir(jdir, prefix, ids))
    _assert_same(jio.load_reference_gz_dir(tdir, prefix, ids),
                 jio.load_reference_gz_dir(jdir, prefix, ids))


def test_reference_dir_beside_a_missing_npz(tmp_path):
    ds = jgen.generate("QP", num_var=10, num_ineq=5, num_eq=5, data_size=3,
                       seed=4)
    root = str(tmp_path)
    d = os.path.splitext(tio.dataset_path(root, "QP", 10, 5, 5))[0]
    tio.save_reference_gz_dir(ds, d, "qp")
    t = tio.load_dataset(root, "QP", 10, 5, 5, data_size=3)
    _assert_same(t, jio.load_dataset(root, "QP", 10, 5, 5, data_size=3))
    np.testing.assert_array_equal(t.Q, ds.Q.astype(np.float64))
    with pytest.raises(FileNotFoundError):
        tio.load_dataset(root, "QP", 11, 5, 5)


def test_qplib_branch(tmp_path):
    ds = jgen.generate("Random_QP", num_var=9, num_ineq=4, data_size=3,
                       seed=5)
    d = str(tmp_path / "QPLIB_8790")
    jio.save_reference_gz_dir(ds, d, "qplib_8790")
    t = tio.load_dataset(str(tmp_path), "QPLIB", qplib_num=8790,
                         data_size=3)
    j = jio.load_dataset(str(tmp_path), "QPLIB", qplib_num=8790,
                         data_size=3)
    _assert_same(t, j)
    assert t.prob_type == "qplib_8790" and t.size == 3
    np.testing.assert_array_equal(t.A0, ds.A0.astype(np.float64))
    with pytest.raises(FileNotFoundError):
        tio.load_dataset(str(tmp_path), "QPLIB", qplib_num=1, data_size=3)


def test_write_family_matches_jax(tmp_path):
    td = tmm.write_family(str(tmp_path / "t"), data_size=6, seed=17)
    jd = jmm.write_family(str(tmp_path / "j"), data_size=6, seed=17)
    assert td.endswith("MM_HS35") and sorted(os.listdir(td)) == \
        sorted(os.listdir(jd))
    t = tio.load_dataset(str(tmp_path / "t"), "MM_HS35", 3, data_size=6)
    _assert_same(t, jio.load_dataset(str(tmp_path / "j"), "MM_HS35", 3,
                                     data_size=6))
    _assert_same(tmm.build_family(6, 17), jmm.build_family(6, 17))
    Qh = 2.0 * t.Q[0]
    obj = 0.5 * t.x_opt[0] @ Qh @ t.x_opt[0] + t.p[0] @ t.x_opt[0]
    np.testing.assert_allclose(obj, tmm.HS35_OBJ, atol=1e-3)
