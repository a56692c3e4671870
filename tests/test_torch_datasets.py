"""The port's host data (shineon_tpu_torch.datasets and
tools/synthetic_data.py) against the JAX package on the CPU: each dataset's
items against the JAX datasets' PIL path on the tests/fixtures.py trees,
key for key (uint8 and flow arrays bit for bit, names equal); the
DataLoader's batch order against the JAX DataLoader's; threaded batches
against serial ones; and the port's tree writer against tests/fixtures.py,
byte for byte.

The JAX datasets decode with their C++ staging library where it builds
(it does on this host), so the items are compared with
``shineon_tpu.native.get_lib`` patched to return None inside each test,
which puts the JAX package on its PIL path and changes nothing in it.
``test_native_decode_against_pil`` reports whether the native decode
equals PIL's on the fixtures (ROADMAP.md §3)."""

import filecmp
import os
import os.path as osp

import numpy as np
import pytest

import shineon_tpu.native as jnative
from fixtures import make_mpv_fixture, make_viton_fixture, make_vvt_fixture
from shineon_tpu.datasets import find_dataset_using_name as j_find_dataset
from shineon_tpu.datasets.loader import DataLoader as JDataLoader
from shineon_tpu_torch.datasets import find_dataset_using_name
from shineon_tpu_torch.datasets.loader import DataLoader
from shineon_tpu_torch.options import gmm_options, sams_options, tom_options
from shineon_tpu_torch.tools.synthetic_data import make_mpv_tree, make_viton_tree, make_vvt_tree

SIZE = dict(fine_height=64, fine_width=48)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    make_viton_fixture(str(root / "viton"), n=3)
    make_vvt_fixture(str(root / "vvt"), n_videos=2, frames=3, height=64, width=48)
    make_vvt_fixture(str(root / "vvt"), n_videos=2, frames=3, datamode="test", height=64,
                     width=48)
    make_mpv_fixture(str(root / "mpv"), n=2)
    return {k: str(root / k) for k in ("viton", "vvt", "mpv")}


@pytest.fixture
def pil_path(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


def assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for key, ref in a.items():
        out = b[key]
        if isinstance(ref, np.ndarray):
            assert out.dtype == ref.dtype and out.shape == ref.shape, key
            np.testing.assert_array_equal(out, ref, err_msg=key)
        elif isinstance(ref, np.floating):
            assert type(out) is type(ref) and out == ref, key
        else:
            assert out == ref, key


def _options(trees, builder, **kw):
    return builder(viton_dataroot=trees["viton"], vvt_dataroot=trees["vvt"],
                   mpv_dataroot=trees["mpv"], **SIZE, **kw)


CASES = {
    # the GMM on VITON: product cloths, agnostic + cocopose, the grid image
    "viton_gmm": lambda t: ("viton", _options(t, gmm_options), False),
    # TOM on VITON: the warp-cloth folder, agnostic + cocopose (VITON has no densepose)
    "viton_tom": lambda t: ("viton", _options(t, tom_options, person_inputs=["agnostic",
                                                                             "cocopose"]), False),
    # SAMS on VVT: 2-frame clips, flow, densepose; the main split and the val split
    "vvt_sams": lambda t: ("vvt", _options(t, sams_options, n_frames_total=2, n_frames_now=2,
                                           val_fraction=0.5), False),
    "vvt_sams_val": lambda t: ("vvt", _options(t, sams_options, n_frames_total=2,
                                               n_frames_now=2, val_fraction=0.5), True),
    # TOM on VVT reading warp_cloth_dir (the fixture's own warp-cloth tree)
    "vvt_tom_warp_cloth_dir": lambda t: ("vvt", _options(
        t, tom_options, dataset="vvt", warp_cloth_dir=osp.join(t["vvt"], "train", "warp-cloth"),
        val_fraction=0.5), False),
    # the try-on task: random_tryon's RandomState(420) pairing, test split
    "vvt_random_tryon": lambda t: ("vvt", _options(t, gmm_options, dataset="vvt",
                                                   is_train=False, random_tryon=True), False),
    "mpv_gmm": lambda t: ("mpv", _options(t, gmm_options, dataset="mpv"), False),
    "viton_vvt_mpv_gmm": lambda t: ("viton_vvt_mpv", _options(t, gmm_options,
                                                              dataset="viton_vvt_mpv"), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_items_match_jax_pil_path(trees, pil_path, case):
    """Every item of the dataset (or its validation split) equals the JAX
    dataset's, built from the same options."""
    name, opt, validation = CASES[case](trees)
    jcls, cls = j_find_dataset(name), find_dataset_using_name(name)
    if validation:
        ref, mine = jcls.make_validation_dataset(opt), cls.make_validation_dataset(opt)
    else:
        ref, mine = jcls(opt), cls(opt)
    assert len(mine) == len(ref) > 0
    for i in range(len(ref)):
        assert_items_equal(ref[i], mine[i])


def test_vvt_clip_walk_back_and_val_split(trees):
    """A clip never crosses into the video before: the first frames of a
    video repeat its first index; the val split is the last video."""
    opt = _options(trees, sams_options, n_frames_total=3, n_frames_now=3, val_fraction=0.5)
    train = find_dataset_using_name("vvt")(opt)
    val = find_dataset_using_name("vvt").make_validation_dataset(opt)
    assert [train.collect_n_frames_indices(i) for i in range(3)] == [[0, 0, 0], [0, 0, 1],
                                                                    [0, 1, 2]]
    assert {osp.basename(osp.dirname(p)) for p in train.image_names} == {"vid0-g00"}
    assert {osp.basename(osp.dirname(p)) for p in val.image_names} == {"vid1-g01"}
    item = train[2]
    assert item["image_u8"].shape == (3, 64, 48, 3) and item["flow_raw"].shape == (3, 64, 48, 2)
    assert item["image_name"] == [osp.join("vid0-g00", f"frame_00{t}.png") for t in range(3)]


def test_missing_files(trees, tmp_path):
    """A missing flow or densepose file is an absent annotation (zeros, flag
    0); a missing person image raises, and a file that does not decode
    raises."""
    import shutil

    root = tmp_path / "vvt"
    shutil.copytree(trees["vvt"], root)
    opt = sams_options(vvt_dataroot=str(root), n_frames_total=1, n_frames_now=1, **SIZE)
    os.remove(root / "train" / "optical_flow" / "vid0-g00" / "frame_001.flo")
    os.remove(root / "train" / "densepose" / "vid0-g00" / "frame_001_IUV.png")
    item = find_dataset_using_name("vvt")(opt)[1]
    assert item["flow_valid"][0] == 0 and not item["flow_raw"].any()
    assert item["densepose_valid"][0] == 0 and not item["densepose_u8"].any()
    (root / "train" / "train_frames" / "vid0-g00" / "frame_002.png").write_bytes(b"not a png")
    with pytest.raises(Exception, match="cannot identify image file"):
        find_dataset_using_name("vvt")(opt)[2]
    viton = tmp_path / "viton"
    shutil.copytree(trees["viton"], viton)
    os.remove(viton / "train" / "image" / "person_1.jpg")
    with pytest.raises(FileNotFoundError):
        find_dataset_using_name("viton")(gmm_options(viton_dataroot=str(viton), **SIZE))[1]


def test_native_decode_against_pil(trees):
    """Whether the JAX package's native decode (libjpeg, libpng) gives the
    items its PIL path gives, on the fixtures. Recorded, not required: the
    port decodes with PIL only. The fixture's persons and cloths are JPEG."""
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native staging library does not build here")
    opt = _options(trees, gmm_options)
    native_item = j_find_dataset("viton")(opt)[0]
    lib = jnative.get_lib
    jnative.get_lib = lambda: None
    try:
        pil_item = j_find_dataset("viton")(opt)[0]
    finally:
        jnative.get_lib = lib
    differs = {k: int(np.abs(native_item[k].astype(int) - pil_item[k].astype(int)).max())
               for k in native_item if isinstance(native_item[k], np.ndarray)
               and not np.array_equal(native_item[k], pil_item[k])}
    print(f"native decode against PIL, max |difference| a key: {differs or 'none'}")
    assert set(differs) <= {"image_u8", "prev_image_u8", "cloth_u8"}  # the JPEG ones


# ------------------------------------------------------------------ loader

class Indices:
    """A dataset whose item i is its index, a name and a float."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": np.int64(i), "name": f"s{i}", "value": np.float32(i) / 2,
                "frames": [f"f{i}a", f"f{i}b"]}


LOADER_CASES = [
    dict(n=11, batch_size=3),
    dict(n=11, batch_size=3, drop_last=False),
    dict(n=11, batch_size=2, process_count=2, process_index=0),
    dict(n=11, batch_size=2, process_count=2, process_index=1),
    dict(n=11, batch_size=2, process_count=2, process_index=1, drop_last=False),
    dict(n=10, batch_size=3, limit_batches=0.5),
    dict(n=10, batch_size=3, limit_batches=2),
    dict(n=10, batch_size=3, limit_batches=1.0, drop_last=False),
    dict(n=10, batch_size=3, limit_batches=0.1),
    dict(n=10, batch_size=2, limit_batches=2.0, process_count=2, process_index=1),
    dict(n=9, batch_size=4, shuffle=False, drop_last=False),
]


@pytest.mark.parametrize("case", range(len(LOADER_CASES)))
def test_loader_index_order_matches_jax(case):
    """The batches' indices over two epochs, and the loader's length, equal
    the JAX DataLoader's for the same arguments."""
    kw = dict(LOADER_CASES[case])
    dataset = Indices(kw.pop("n"))
    kw.setdefault("process_index", 0)
    kw.setdefault("process_count", 1)
    mine, ref = DataLoader(dataset, **kw), JDataLoader(dataset, **kw)
    assert len(mine) == len(ref)
    for epoch in range(2):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = [b["index"].tolist() for b in mine]
        assert got == [b["index"].tolist() for b in ref]
        assert got == [b.tolist() for b in mine.batch_indices()]
    assert len(got) == len(mine)


def test_collate_matches_jax():
    from shineon_tpu.datasets.loader import collate as j_collate

    from shineon_tpu_torch.datasets.loader import collate

    samples = [Indices(4)[i] for i in range(3)]
    samples[0]["strings"] = np.array(["a", "b"])
    samples[1]["strings"] = np.array(["c", "d"])
    samples[2]["strings"] = np.array(["e", "f"])
    out, ref = collate(samples), j_collate(samples)
    assert sorted(out) == sorted(ref)
    for key in ref:
        if isinstance(ref[key], np.ndarray):
            assert out[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(out[key], ref[key])
        else:
            assert out[key] == ref[key]


def test_threaded_batches_equal_serial(trees):
    """Four decode threads and a prefetch queue of 2 give the serial
    loader's batches, array for array and name for name."""
    opt = _options(trees, sams_options, n_frames_total=2, n_frames_now=2, val_fraction=0.5)
    dataset = find_dataset_using_name("vvt")(opt)
    serial = list(DataLoader(dataset, batch_size=2, workers=0))
    threaded = list(DataLoader(dataset, batch_size=2, workers=4))
    assert len(serial) == len(threaded) == 1
    for a, b in zip(serial, threaded):
        assert_items_equal(a, b)


class Failing(Indices):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 does not decode")
        return super().__getitem__(i)


def test_threaded_decode_error_raises():
    """A decode error in a worker thread reaches the consumer, which
    raises it (the JAX loader's producer dies and leaves its consumer
    waiting)."""
    loader = DataLoader(Failing(12), batch_size=2, shuffle=False, workers=3)
    seen = []
    with pytest.raises(ValueError, match="sample 5"):
        for batch in loader:
            seen.append(batch["index"].tolist())
    assert seen == [[0, 1], [2, 3]]


def test_threaded_consumer_stops_early():
    """A consumer that stops after one batch leaves no producer running."""
    import threading

    before = threading.active_count()
    for _ in DataLoader(Indices(40), batch_size=2, workers=2):
        break
    assert threading.active_count() == before


# ------------------------------------------------------------- the writer

def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.funny_files, (a, b)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors, (a, mismatch, errors)
    for sub in cmp.common_dirs:
        _same_tree(osp.join(a, sub), osp.join(b, sub))


@pytest.mark.parametrize("kind", ["viton", "vvt", "mpv"])
def test_synthetic_trees_equal_fixtures(tmp_path, kind):
    """The port's writer gives tests/fixtures.py's trees byte for byte, for
    the same seed, size and counts."""
    a, b = str(tmp_path / "port"), str(tmp_path / "fixture")
    if kind == "viton":
        make_viton_tree(a, n=3, seed=4)
        make_viton_fixture(b, n=3, seed=4)
    elif kind == "vvt":
        make_vvt_tree(a, n_videos=2, frames=3, seed=4, height=40, width=32)
        make_vvt_fixture(b, n_videos=2, frames=3, seed=4, height=40, width=32)
    else:
        make_mpv_tree(a, n=2, seed=4)
        make_mpv_fixture(b, n=2, seed=4)
    _same_tree(a, b)
