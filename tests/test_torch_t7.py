"""Port parity, the Torch7 reader: multipathnet_tpu_torch/data/t7.py and
ProposalStore.from_t7 against the JAX package's, on the byte fixtures of
tests/test_t7.py (written by tests/t7write.py), with exact equality of
every value, dtype and structure, and the reader's own traps checked on
the port's side."""

import struct

import numpy as np
import pytest

from multipathnet_tpu.data import t7 as jt7
from multipathnet_tpu.data.proposals import ProposalStore as JStore
from multipathnet_tpu_torch.data import t7 as tt7
from multipathnet_tpu_torch.data.proposals import ProposalStore as TStore
from t7write import (GraphWriter, w_bool, w_int, w_long, w_nil, w_num,
                     w_object, w_rawstr, w_ref, w_storage, w_str, w_table,
                     w_tensor)


def same(a, b, path="root"):
    """Exact structural equality across the two packages' records."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif type(a).__name__ == "T7Object":
        assert type(b).__name__ == "T7Object", path
        assert (a.name, a.version) == (b.name, b.version), path
        same(a.fields, b.fields, path + ".fields")
    elif type(a).__name__ == "T7Function":
        assert type(b).__name__ == "T7Function", path
        assert a.dump == b.dump, path
        same(a.upvalues, b.upvalues, path + ".upvalues")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _linear(gw, w, b):
    return gw.module("nn.Linear", {"weight": w, "bias": b})


def _fixtures():
    vals = np.arange(8, dtype=np.float64)
    st4 = w_storage(3, "torch.FloatStorage", np.arange(4, dtype=np.float32))
    shared = w_table(4, [
        (w_str("a"), w_tensor(1, "torch.FloatTensor", [4], [1], 1, st4)),
        (w_str("b"), w_tensor(2, "torch.FloatTensor", [2], [1], 3,
                              w_ref(3, jt7.TYPE_TORCH))),
        (w_str("a2"), w_ref(1, jt7.TYPE_TORCH))])
    v3 = np.arange(3, dtype=np.float32)
    long4 = (w_int(jt7.TYPE_TORCH) + w_int(1) + w_rawstr("V 1")
             + w_rawstr("torch.FloatTensor") + struct.pack("<i", 1)
             + struct.pack("<i", 3) + struct.pack("<i", 1)
             + struct.pack("<i", 1)
             + w_int(jt7.TYPE_TORCH) + w_int(2) + w_rawstr("V 1")
             + w_rawstr("torch.FloatStorage") + struct.pack("<i", 3)
             + v3.tobytes())
    v2 = np.arange(2, dtype=np.float32)
    preversion = (w_int(jt7.TYPE_TORCH) + w_int(1)
                  + w_rawstr("torch.FloatTensor") + w_int(1) + w_long(2)
                  + w_long(1) + w_long(1)
                  + w_int(jt7.TYPE_TORCH) + w_int(2)
                  + w_rawstr("torch.FloatStorage") + w_long(2)
                  + v2.tobytes())
    fn = (w_int(jt7.TYPE_RECUR_FUNCTION) + w_int(1) + w_int(4) + b"\x1bLua"
          + w_table(2, [(w_str("up"), w_num(1))]))
    legacy = (w_int(jt7.TYPE_LEGACY_RECUR_FUNCTION) + w_int(1) + w_int(4)
              + b"\x1bLua" + w_nil())
    rng = np.random.default_rng(0)
    gw = GraphWriter()
    graph = gw.container("nn.Sequential", [
        _linear(gw, rng.normal(size=(3, 4)), rng.normal(size=3)),
        gw.container("nn.ConcatTable", [
            _linear(gw, rng.normal(size=(2, 3)), rng.normal(size=2))]),
        gw.module("nn.SpatialConvolutionMM",
                  {"weight": rng.normal(size=(2, 3 * 3 * 3)),
                   "bias": rng.normal(size=2)},
                  {"kW": 3, "kH": 3, "nInputPlane": 3, "nOutputPlane": 2})])
    return {
        "number": (w_num(3.5), {}),
        "integer": (w_num(7.0), {}),
        "string": (w_str("hello"), {}),
        "booleans": (w_table(1, [(w_num(1), w_bool(True)),
                                 (w_num(2), w_bool(False))]), {}),
        "nil": (w_nil(), {}),
        "memoized_table": (w_table(1, [
            (w_str("a"), w_table(2, [(w_str("x"), w_num(1))])),
            (w_str("b"), w_ref(2)), (w_str("n"), w_num(4))]), {}),
        "lua_array": (w_table(1, [(w_num(i), w_num(i * 10))
                                  for i in (1, 2, 3)]), {}),
        "float_tensor": (w_tensor(1, "torch.FloatTensor", [2, 3], [3, 1], 1,
                                  w_storage(2, "torch.FloatStorage",
                                            np.arange(6, dtype=np.float32))),
                         {}),
        "offset_transposed": (w_tensor(1, "torch.DoubleTensor", [2, 3],
                                       [1, 2], 3,
                                       w_storage(2, "torch.DoubleStorage",
                                                 vals)), {}),
        "shared_storage": (shared, {}),
        "byte_tensor": (w_tensor(1, "torch.ByteTensor", [3], [1], 1,
                                 w_storage(2, "torch.ByteStorage",
                                           np.array([1, 2, 250], np.uint8))),
                        {}),
        "long_tensor": (w_tensor(1, "torch.LongTensor", [2], [1], 1,
                                 w_storage(2, "torch.LongStorage",
                                           np.array([-5, 2 ** 40],
                                                    np.int64))), {}),
        "empty_tensor": (w_tensor(1, "torch.FloatTensor", [], [], 1,
                                  w_nil()), {}),
        "long_size_4": (long4, {"long_size": 4}),
        "pre_versioning": (preversion, {}),
        "function": (w_table(3, [(w_str("f"), fn), (w_str("x"), w_num(2))]),
                     {}),
        "legacy_function_reref": (w_table(2, [
            (w_str("f"), legacy),
            (w_str("g"), w_ref(1, jt7.TYPE_LEGACY_RECUR_FUNCTION)),
            (w_str("x"), w_num(5))]), {}),
        "nn_graph": (graph, {}),
    }


FIXTURES = _fixtures()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reader_matches_reference(name):
    """Every record type of tests/test_t7.py, read by both packages:
    equal values, dtypes and structure (exact)."""
    data, kw = FIXTURES[name]
    same(tt7.loads(data, **kw), jt7.loads(data, **kw))


def test_reader_traps():
    """The reader's traps, on the port's side: integral doubles become
    ints, memoized tables and tensors resolve to one object, tensors share
    a storage through 1-based offsets, strides and offsets map through
    as_strided, a function record stays inert bytes and the stream stays
    in sync after a re-referenced one, and a non-array table refuses
    as_list."""
    assert isinstance(tt7.loads(FIXTURES["integer"][0]), int)
    out = tt7.loads(FIXTURES["memoized_table"][0])
    assert out["a"] is out["b"]
    out = tt7.loads(FIXTURES["shared_storage"][0])
    np.testing.assert_array_equal(out["b"], np.arange(4)[2:])
    assert out["a"] is out["a2"]
    vals = np.arange(8, dtype=np.float64)
    np.testing.assert_array_equal(
        tt7.loads(FIXTURES["offset_transposed"][0]),
        np.lib.stride_tricks.as_strided(vals[2:], (2, 3), (8, 16)))
    out = tt7.loads(FIXTURES["function"][0])
    assert isinstance(out["f"], tt7.T7Function) and out["f"].dump == b"\x1bLua"
    out = tt7.loads(FIXTURES["legacy_function_reref"][0])
    assert out["f"] is out["g"] and out["x"] == 5
    np.testing.assert_array_equal(
        tt7.loads(FIXTURES["long_size_4"][0], long_size=4), np.arange(3))
    assert tt7.as_list(tt7.loads(FIXTURES["lua_array"][0])) == [10, 20, 30]
    with pytest.raises(ValueError):
        tt7.as_list({1: "a", 3: "c"})
    with pytest.raises(ValueError, match="truncated"):
        tt7.loads(FIXTURES["float_tensor"][0][:-3])


def test_state_dict_and_load_t7_match_reference(tmp_path):
    """t7.state_dict of an nn graph, and import_weights.load_t7 from disk,
    equal the reference's (runtime buffers skipped, SpatialConvolutionMM
    kept flat)."""
    from multipathnet_tpu.models.import_weights import load_t7 as jload
    from multipathnet_tpu_torch.models.import_weights import load_t7 as tload

    data = FIXTURES["nn_graph"][0]
    got = tt7.state_dict(tt7.loads(data))
    same(got, jt7.state_dict(jt7.loads(data)))
    assert "modules.1.weight" in got and not any("train" in k for k in got)
    path = tmp_path / "m.t7"
    path.write_bytes(data)
    same(tload(str(path)), jload(str(path)))


def _proposal_file(tmp_path, name, fields):
    path = tmp_path / name
    path.write_bytes(w_table(100, fields))
    return str(path)


def _tensor(gw, arr):
    return gw.tensor(np.asarray(arr, np.float32))


@pytest.mark.parametrize("layout", ["tables_ids", "tables_no_ids",
                                    "aliases", "tensor3d", "zero_based"])
def test_proposal_store_from_t7_matches_reference(tmp_path, layout):
    """ProposalStore.from_t7 against the reference's on each accepted
    layout: per-image box tables with scores and ids, without ids (ids
    0..I-1), the field aliases (bboxes, objn, indexes), one (I, P, 4)
    tensor, and one_based=False. Boxes, scores, offsets and ids equal
    exactly; the 1-based corners become (x1 - 1, y1 - 1, x2, y2)."""
    gw = GraphWriter()
    b1 = np.array([[1, 1, 10, 20], [5, 6, 15, 16]], np.float32)
    b2 = np.array([[2, 3, 8, 9]], np.float32)
    s1, s2 = np.array([0.9, 0.5], np.float32), np.array([0.7], np.float32)

    def tbl(*items):
        return w_table(gw.nid(), [(w_num(i + 1), x)
                                  for i, x in enumerate(items)])

    boxes = tbl(_tensor(gw, b1), _tensor(gw, b2))
    scores = tbl(_tensor(gw, s1), _tensor(gw, s2))
    ids = tbl(w_num(101), w_num(202))
    kw = {}
    if layout == "tables_ids":
        fields = [(w_str("boxes"), boxes), (w_str("scores"), scores),
                  (w_str("ids"), ids)]
    elif layout == "tables_no_ids":
        fields = [(w_str("boxes"), boxes), (w_str("images"), ids)]
    elif layout == "aliases":
        fields = [(w_str("bboxes"), boxes), (w_str("objn"), scores),
                  (w_str("indexes"), ids)]
    elif layout == "tensor3d":
        both = np.stack([b1, b1 + 1])
        fields = [(w_str("proposals"), _tensor(gw, both)),
                  (w_str("scores"), _tensor(gw, np.stack([s1, s1])))]
    else:
        fields = [(w_str("boxes"), boxes), (w_str("scores"), scores)]
        kw = {"one_based": False, "image_ids": [7, 9]}
    path = _proposal_file(tmp_path, f"{layout}.t7", fields)
    got, want = TStore.from_t7(path, **kw), JStore.from_t7(path, **kw)
    for field in ("boxes", "scores", "offsets", "image_ids"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    if layout == "tables_ids":
        np.testing.assert_array_equal(got.image_ids, [101, 202])
        np.testing.assert_array_equal(
            got.for_image_id(101)[0], b1 - np.array([1, 1, 0, 0]))
    if layout == "tables_no_ids":
        np.testing.assert_array_equal(got.image_ids, [0, 1])


def test_proposal_store_from_t7_refuses_files_without_boxes(tmp_path):
    path = _proposal_file(tmp_path, "bad.t7", [(w_str("scores"), w_num(1))])
    with pytest.raises(ValueError, match="no boxes"):
        TStore.from_t7(path)
