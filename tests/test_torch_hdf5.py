"""The port's HDF5 subset (``io/hdf5.py``) against h5py both ways: files
the port writes read equal through h5py (data, dtypes, shapes, attrs; a
str attr stays str), files h5py writes (contiguous, chunked, gzip, nested
``tiles/coords``, many members, many attributes) read equal through the
port; an empty (0, D) dataset round-trips; what the reader refuses raises
a ValueError that names it. The tessellation and features H5 of the port
and of the JAX package read each other's files."""

import numpy as np
import pytest

import h5py

from path_gene_multimodal_tpu.core import artifacts as jart
from path_gene_multimodal_tpu_torch.core import artifacts as tart
from path_gene_multimodal_tpu_torch.io import hdf5

DTYPES = [np.int64, np.int32, np.int16, np.uint8, np.uint64, np.float32, np.float64, bool, "S7"]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == bool:
        return rng.random(shape) < 0.5
    if dtype == "S7":
        return np.array([f"t{i}".encode() for i in range(int(np.prod(shape)))]).reshape(shape)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(5,), (7, 3), (0, 512), (2, 3, 4)])
def test_port_file_reads_in_h5py(tmp_path, dtype, shape):
    a = _array(dtype, shape)
    p = hdf5.write_h5(tmp_path / "x.h5", {"data": a, "grp/sub/data": a[:1]})
    with h5py.File(p, "r") as f:
        _assert_same(f["data"][...], a)
        _assert_same(f["grp/sub/data"][...], a[:1])
    with hdf5.File(p) as f:
        _assert_same(f["data"][...], a)
        assert f["data"].shape == a.shape


ATTRS = {
    "model_type": "CLIP", "unicode": "µm – é", "dim": 512, "mpp": 0.25,
    "f32": np.float32(1.5), "i32": np.int32(-7), "u8": np.uint8(200), "flag": np.bool_(True),
    "arr": np.arange(4), "farr": np.linspace(0, 1, 3).astype(np.float32),
    "columns": ["x", "y", "level"], "bytes": np.bytes_(b"abc"),
}


def _check_attrs(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, str):
            assert isinstance(g, str) and g == v, (k, g)
        elif isinstance(v, list):
            assert [str(x) for x in g] == v, (k, g)
        else:
            a = np.asarray(v)
            assert np.asarray(g).dtype == a.dtype and np.array_equal(g, a), (k, g, v)


def test_attrs_both_ways(tmp_path):
    p = hdf5.write_h5(tmp_path / "a.h5", {"coords": (np.zeros((3, 2), np.int64), ATTRS)}, ATTRS)
    with h5py.File(p, "r") as f:
        _check_attrs(dict(f.attrs), ATTRS)
        _check_attrs(dict(f["coords"].attrs), ATTRS)
    q = tmp_path / "b.h5"
    with h5py.File(q, "w") as f:
        d = f.create_dataset("coords", data=np.zeros((3, 2), np.int64))
        for k, v in ATTRS.items():
            f.attrs[k] = v
            d.attrs[k] = v
    with hdf5.File(q) as f:
        _check_attrs(dict(f.attrs), ATTRS)
        _check_attrs(dict(f["coords"].attrs), ATTRS)


@pytest.mark.parametrize("layout", ["contiguous", "chunked", "gzip", "gzip_ragged"])
def test_h5py_layouts_read_equal(tmp_path, layout):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 10**6, (1003, 2)).astype(np.int64)
    f32 = rng.standard_normal((57, 33)).astype(np.float32)
    kw = {"contiguous": {}, "chunked": {"chunks": (100, 2)},
          "gzip": {"chunks": (128, 2), "compression": "gzip"},
          "gzip_ragged": {"chunks": (7, 1), "compression": "gzip", "compression_opts": 9}}[layout]
    p = tmp_path / "h.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("tiles/coords", data=a, **kw)
        f.create_dataset("features", data=f32, **({**kw, "chunks": (10, 5)} if kw else {}))
        f.create_dataset("empty", data=np.zeros((0, 4), np.float32))
        f.create_dataset("be", data=np.arange(5, dtype=">i4"))
    with hdf5.File(p) as f:
        _assert_same(f["tiles/coords"][...], a)
        _assert_same(f["features"][...], f32)
        _assert_same(f["empty"][...], np.zeros((0, 4), np.float32))
        np.testing.assert_array_equal(f["be"][...], np.arange(5))
        assert "tiles" in f and "tiles/x" not in f and "nope" not in f


def test_many_members_and_attrs(tmp_path):
    """More members than one symbol-table node holds, both ways (h5py's up
    to a two-level B-tree); more attributes than h5py's first object header
    block holds."""
    data = {f"g/d{i:03d}": np.full(3, i) for i in range(70)}
    p = hdf5.write_h5(tmp_path / "m.h5", data)
    with h5py.File(p, "r") as f:
        assert sorted(f["g"].keys()) == sorted(k[2:] for k in data)
        for k, v in data.items():
            _assert_same(f[k][...], v)
    # h5py: a group past one B-tree node's 32 symbol-table nodes (a level-1 tree)
    many = {f"g/d{i:03d}": np.full(2, i) for i in range(300)}
    q = tmp_path / "n.h5"
    with h5py.File(q, "w") as f:
        for k, v in many.items():
            f.create_dataset(k, data=v)
        for i in range(40):
            f.attrs[f"a{i}"] = i
    with hdf5.File(q) as f:
        assert f["g"].keys() == sorted(k[2:] for k in many)
        for k, v in many.items():
            _assert_same(f[k][...], v)
        assert dict(f.attrs) == {f"a{i}": i for i in range(40)}


def _patched_message_type(path, name: bytes, new_type: int):
    """Rewrite the type of the attribute message whose name is ``name``
    (its header sits 16 bytes before the name) — a file the writer never
    makes, for the reader's refusals."""
    raw = bytearray(path.read_bytes())
    at = raw.index(name + b"\0") - 16
    raw[at : at + 2] = new_type.to_bytes(2, "little")
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("case", ["superblock", "v2_header", "dense_attrs", "link_messages",
                                  "shuffle", "fletcher32", "lzf", "not_hdf5"])
def test_refusals_name_the_feature(tmp_path, case):
    p = tmp_path / "r.h5"
    a = np.arange(100, dtype=np.int64)
    want = {"superblock": "superblock version 3", "v2_header": "version-2 object headers",
            "dense_attrs": "dense attribute storage", "link_messages": "link messages",
            "shuffle": "filter shuffle", "fletcher32": "filter fletcher32",
            "lzf": "filter 32000", "not_hdf5": "not an HDF5 file"}[case]
    if case == "superblock":
        with h5py.File(p, "w", libver="latest") as f:
            f.create_dataset("x", data=a)
    elif case == "v2_header":
        with h5py.File(p, "w", libver=("earliest", "latest")) as f:
            f.create_group("g", track_order=True).create_dataset("x", data=a)
    elif case in ("dense_attrs", "link_messages"):
        hdf5.write_h5(p, {"x": a}, {"only_attribute": 7})
        _patched_message_type(p, b"only_attribute", 0x15 if case == "dense_attrs" else 0x6)
    elif case == "not_hdf5":
        p.write_bytes(b"not an hdf5 file at all")
    else:
        kw = {"shuffle": {"shuffle": True}, "fletcher32": {"fletcher32": True},
              "lzf": {"compression": "lzf"}}[case]
        with h5py.File(p, "w") as f:
            f.create_dataset("x", data=a, chunks=(10,), **kw)
    with pytest.raises(ValueError, match=want):
        with hdf5.File(p) as f:
            f.visititems(lambda name, obj: getattr(obj, "read", lambda: None)())


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="attribute value"):
        hdf5.write_h5(tmp_path / "o.h5", {"x": np.arange(3)}, {"obj": {"a": 1}})
    with pytest.raises(ValueError, match="dtype"):
        hdf5.write_h5(tmp_path / "c.h5", {"x": np.zeros(3, np.complex64)})


def test_tessellation_h5_both_packages(tmp_path):
    coords = np.array([[0, 0], [224, 0], [448, 224]], np.int64)
    kw = dict(tile_size=224, mpp=0.25, extra_attrs={"slide_width": 2240, "slide_height": 2016})
    tp = tart.write_tessellation_h5(tmp_path / "t.h5", coords, **kw)
    jp = jart.write_tessellation_h5(tmp_path / "j.h5", coords, **kw)
    for reader in (tart.read_tessellation_h5, jart.read_tessellation_h5):
        a, b = reader(tp), reader(jp)
        _assert_same(a["coords"], b["coords"])
        assert a["columns"] == b["columns"] and a["level"] is None and b["level"] is None
        assert {k: np.asarray(v).tolist() for k, v in a["attrs"].items()} == {
            k: np.asarray(v).tolist() for k, v in b["attrs"].items()}
    assert tart.infer_tile_size_from_attrs(tart.read_tessellation_h5(jp)["attrs"]) == 224


def _schema_files(tmp_path):
    """The five coordinate schemas the reference reads, written by h5py."""
    rng = np.random.default_rng(3)
    xy = rng.integers(0, 5000, (9, 2)).astype(np.int64)
    lvl = rng.integers(0, 3, 9)
    files = {}
    for name, build in {
        "coords": lambda f: f.create_dataset("coords", data=xy),
        "locations": lambda f: f.create_dataset("locations", data=xy),
        "tiles_coords": lambda f: f.create_dataset("tiles/coords", data=xy),
        "xy": lambda f: (f.create_dataset("x", data=xy[:, 0]), f.create_dataset("y", data=xy[:, 1])),
        "tiles_xy": lambda f: (f.create_dataset("tiles/x", data=xy[:, 0]),
                               f.create_dataset("tiles/y", data=xy[:, 1])),
        "wild": lambda f: f.create_dataset("a/b/patch_coords", data=xy),
        "width3": lambda f: f.create_dataset("coords", data=np.c_[xy, lvl]),
        "width4": lambda f: f.create_dataset("coords", data=np.c_[xy, xy]),
        "columns": lambda f: f.create_dataset("coords", data=np.c_[lvl, xy]).attrs.create(
            "columns", ["level", "x", "y"]),
        "flat": lambda f: f.create_dataset("coords", data=xy.reshape(-1)),
        "level_ds": lambda f: (f.create_dataset("coords", data=xy),
                               f.create_dataset("level", data=lvl)),
    }.items():
        p = tmp_path / f"{name}.h5"
        with h5py.File(p, "w") as f:
            build(f)
        files[name] = p
    return files


def test_read_tessellation_schemas_match_jax(tmp_path):
    for name, p in _schema_files(tmp_path).items():
        a, b = tart.read_tessellation_h5(p), jart.read_tessellation_h5(p)
        _assert_same(a["coords"], b["coords"])
        _assert_same(a["raw_coords"], b["raw_coords"])
        assert a["columns"] == b["columns"], name
        assert (a["level"] is None) == (b["level"] is None), name
        if a["level"] is not None:
            _assert_same(a["level"], b["level"])
    with h5py.File(tmp_path / "none.h5", "w") as f:
        f.create_dataset("other", data=np.arange(3))
    with pytest.raises(ValueError, match="no tile-coordinate dataset"):
        tart.read_tessellation_h5(tmp_path / "none.h5")


@pytest.mark.parametrize("n", [0, 17])
def test_features_h5_both_packages(tmp_path, n):
    feats = np.random.default_rng(n).standard_normal((n, 512)).astype(np.float32)
    tp = tart.write_features_h5(tmp_path / "t.h5", feats, model_type="Virchow2")
    jp = jart.write_features_h5(tmp_path / "j.h5", feats, model_type="Virchow2")
    for reader in (tart.read_features_h5, jart.read_features_h5):
        for p in (tp, jp):
            r = reader(p)
            _assert_same(r["features"], feats)
            _assert_same(r["tile_index"], np.arange(n, dtype=np.int64))
            assert r["attrs"]["model_type"] == "Virchow2" and r["attrs"]["dim"] == 512
            assert isinstance(r["attrs"]["model_type"], str)
