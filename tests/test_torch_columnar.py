"""The PyTorch port's columnar layer against the JAX package's: bucketing,
the numeric and string layouts, the batch round trips, and
``batch_from_numpy`` on a JAX batch's flat arrays."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import column as jcolumn
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch

from spark_rapids_tpu_torch.columnar import column as pcolumn
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar.interop import (batch_from_numpy,
                                                     batch_to_numpy)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 1000, 1 << 20])
def test_bucket_matches_jax(n):
    assert pcolumn.bucket(n) == jcolumn.bucket(n)
    assert pcolumn.string_width_bucket(n % 40) == \
        jcolumn.string_width_bucket(n % 40)


@pytest.mark.parametrize("tname", ["bigint", "int", "double", "float",
                                   "date", "boolean", "smallint"])
def test_numeric_layout_matches_jax(tname):
    rng = np.random.default_rng(3)
    npdt = jdt.of(tname).numpy_dtype
    vals = rng.integers(-100, 100, 300).astype(npdt)
    valid = rng.random(300) < 0.8
    jc = jcolumn.Column.from_numpy(vals, jdt.of(tname), valid)
    pc = pcolumn.Column.from_numpy(vals, pdt.of(tname), valid)
    assert pc.capacity == jc.capacity == 512
    for a, b in zip(pc.arrays(), jc.arrays()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["unicode", "bytes", "object_with_nulls",
                                  "non_ascii"])
def test_string_layout_matches_jax(kind):
    words = ["A", "NO", "", "ABCDEFGHIJ", "R"]
    if kind == "unicode":
        vals = np.array(words * 40)
        py = list(vals)
    elif kind == "bytes":
        vals = np.array([w.encode() for w in words * 40])
        py = [w for w in words * 40]
    elif kind == "object_with_nulls":
        py = [None if i % 7 == 0 else words[i % 5] for i in range(200)]
        vals = np.array(py, dtype=object)
    else:
        py = ["naïve", "日本", "x", None] * 50
        vals = np.array(py, dtype=object)
    jc = jcolumn.Column.from_pylist(py, jdt.STRING)
    pc = pcolumn.Column.from_numpy(vals, pdt.STRING)
    assert pc.data.shape == tuple(jc.data.shape)
    assert pc.data.dtype == torch.uint8 and pc.lengths.dtype == torch.int32
    for a, b in zip(pc.arrays(), jc.arrays()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pc.to_pylist(200) == jc.to_pylist(200)


def test_batch_upload_roundtrip_and_flat_arrays():
    rng = np.random.default_rng(4)
    data = {"k": np.array(["a", "bb", "c"])[rng.integers(0, 3, 1000)],
            "v": rng.normal(size=1000), "d": rng.integers(0, 9000, 1000)
            .astype(np.int32)}
    schema = pdt.Schema([("k", "string"), ("v", "double"), ("d", "date")])
    b = PBatch.from_numpy_dict(data, schema, "cpu")
    assert b.capacity == 1024 and b.num_rows == 1000
    assert len(b.flat_arrays()) == 3 + 2 + 2
    back = PBatch.from_flat_arrays(schema, b.flat_arrays(), b.num_rows)
    assert back.rows() == b.rows()
    rows = b.rows()
    assert rows[5] == (data["k"][5], float(data["v"][5]), int(data["d"][5]))
    # a device-resident count is read once, when asked for
    lazy = PBatch(schema, b.columns, torch.tensor(1000))
    assert not isinstance(lazy.num_rows_raw, int)
    assert lazy.num_rows == 1000 and lazy.num_rows_raw == 1000


def test_batch_from_numpy_on_jax_flat_arrays():
    rng = np.random.default_rng(6)
    py = {"s": [None if i % 9 == 0 else ["x", "yy", "zzz"][i % 3]
                for i in range(300)],
          "i": [None if i % 5 == 0 else int(v)
                for i, v in enumerate(rng.integers(-9, 9, 300))],
          "f": [float(v) for v in rng.normal(size=300)]}
    schema = jdt.Schema([("s", "string"), ("i", "bigint"), ("f", "double")])
    jb = JBatch.from_pydict(py, schema)
    fields = [(f.name, f.dtype.name) for f in jb.schema]
    flat = [np.asarray(a) for a in jb.flat_arrays()]
    pb = batch_from_numpy(fields, flat, jb.num_rows)
    assert pb.rows() == jb.rows()
    out_fields, out_flat, n = batch_to_numpy(pb)
    assert out_fields == fields and n == jb.num_rows
    for a, b in zip(out_flat, flat):
        np.testing.assert_array_equal(a, b)


def test_dtypes_copy_has_the_jax_types():
    for t in jdt.ALL_TYPES:
        p = pdt.of(t.name)
        assert (p.name, p.numpy_dtype, p.byte_width) == \
            (t.name, t.numpy_dtype, t.byte_width)
