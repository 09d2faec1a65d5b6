"""The port's data path (image library, datasets, split, config.yml capsule,
pipelines, DSB2018 preprocessing) against the JAX package's and cv2's."""

import math
import os

import cv2
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from pytorch_nested_unet_tpu.data import native
from pytorch_nested_unet_tpu.data.datasets import ISICDataset as JaxISIC
from pytorch_nested_unet_tpu.data.datasets import SegmentationFolderDataset as JaxFolder
from pytorch_nested_unet_tpu.data.datasets import split_ids as jax_split_ids
from pytorch_nested_unet_tpu.data.preprocess import preprocess_dsb2018 as jax_preprocess
from pytorch_nested_unet_tpu.utils.config import save_config as jax_save_config
from pytorch_nested_unet_tpu_torch.data import image_io
from pytorch_nested_unet_tpu_torch.data.datasets import (
    ISICDataset, SegmentationFolderDataset, list_image_ids, split_ids)
from pytorch_nested_unet_tpu_torch.data.pipeline import (
    DeviceDataStore, HostPrefetchLoader, epoch_batches, resolve_pipeline)
from pytorch_nested_unet_tpu_torch.data.preprocess import preprocess_dsb2018
from pytorch_nested_unet_tpu_torch.utils.config import (dump_config, load_config, parse_config,
                                                       save_config)

H, W = 37, 53


@pytest.mark.parametrize("ns", [range(2, 101), range(101, 201), [670]])
def test_split_ids_equals_sklearn(ns):
    for n in ns:
        ids = [f"im{i:04d}" for i in range(n)]
        assert list(split_ids(ids, 0.2, 41)) == [list(p) for p in jax_split_ids(ids, 0.2, 41)], n


def test_split_ids_sizes_of_dsb2018():
    train, val = split_ids([str(i) for i in range(670)])
    assert (len(train), len(val)) == (536, 134) and not set(train) & set(val)


def test_list_image_ids(tmp_path):
    for name in ("b.png", "a.png", "c.jpg", "d.png.bak"):
        (tmp_path / name).write_bytes(b"")
    assert list_image_ids(str(tmp_path), ".png") == ["a", "b"]
    assert list_image_ids(str(tmp_path), ".jpg") == ["c"]


# ---- config.yml ----

TRICKY = {"milestones": "1,2", "min_lr": 1e-05, "lr": 0.001, "big": 1e20, "inf": math.inf,
          "ninf": -math.inf, "yes_str": "yes", "y_str": "y", "on_str": "On", "half": "0.5",
          "empty": "", "null_str": "null", "tilde": "~", "none": None, "flag": True,
          "json": '{"decoder": "GRU"}', "list": [1, 2.5, "x", None], "octal": "07",
          "hex": "0x1F", "exp": "1e-05", "path": "/tmp/a b/models", "quote": "it's",
          "long": "x" * 90 + " " + "y" * 10, "newline": "a\nb", "gamma": 2 / 3, "n": -3,
          "unicode": "é ✓", "dotfive": ".5"}


def test_port_config_reads_back_with_yaml(tmp_path):
    save_config(TRICKY, str(tmp_path))
    with open(tmp_path / "config.yml") as f:
        text = f.read()
    assert yaml.safe_load(text) == TRICKY
    assert load_config(str(tmp_path)) == TRICKY
    assert "min_lr: 1.0e-05\n" in text and "milestones: '1,2'\n" in text
    keys = [line.split(":")[0] for line in text.splitlines() if not line.startswith("- ")]
    assert keys == sorted(TRICKY)


def test_jax_config_reads_back_in_the_port(tmp_path):
    import train as jax_train

    cfg = jax_train.parse_args(["--dataset", "dsb2018_96", "--arch_kwargs",
                                '{"nb_filter": [4, 8, 16, 32, 64]}', "--data_dir",
                                "/data/some where/inputs"])
    cfg["name"] = "dsb2018_96_NestedUNet_woDS"
    for extra in ({}, TRICKY):
        jax_save_config({**cfg, **extra}, str(tmp_path))
        assert load_config(str(tmp_path)) == {**cfg, **extra}


_TOKENS = ["1,2", "yes", "no", "on", "off", "true", "False", "y", "n", "null", "Null", "~", "",
           "0.5", ".5", "1e-05", "1.0e-05", "-1", "+1", "0x1F", "0b101", "07", "1_000",
           ".inf", "-.Inf", ".nan", "a: b", "#x", "- x", "'q'", '"d"', "{}", "[]", "@x", "%x",
           "a b", " lead", "trail ", "é", "line\nbreak"]
_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-2**63, 2**63),
    st.floats(allow_nan=False), st.sampled_from([1e-05, 1e20, math.inf, -math.inf, 5e-324]),
    st.sampled_from(_TOKENS), st.text(st.characters(min_codepoint=32, max_codepoint=0x2fff,
                                                    blacklist_categories=("Cs", "Zl", "Zp")),
                                      max_size=12))


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(st.from_regex(r"[a-z_][a-z0-9_]{0,11}", fullmatch=True),
                       st.one_of(_SCALARS, st.lists(_SCALARS, max_size=4)), max_size=8))
def test_config_round_trip(cfg):
    text = dump_config(cfg)
    assert yaml.safe_load(text) == cfg
    assert parse_config(text) == cfg
    assert parse_config(yaml.dump(cfg)) == cfg


# ---- the image library ----

@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """One file per colour type and codec: 8-bit gray, BGR, BGRA (opaque and
    clear alpha; partial alpha), palette, 1-bit gray, interlaced RGB, gray +
    alpha (PNG), and colour and gray JPEGs."""
    d = tmp_path_factory.mktemp("codecs")
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (H, W), dtype=np.uint8)
    alpha01 = np.full((H, W, 1), 255, np.uint8)
    alpha01[:5] = 0
    files = {"bgr.png": bgr, "gray.png": gray, "bgra01.png": np.concatenate([bgr, alpha01], 2),
             "bgra.png": np.concatenate([bgr, rng.integers(0, 256, (H, W, 1), np.uint8)], 2),
             "c.jpg": bgr, "g.jpg": gray}
    paths = {}
    for name, arr in files.items():
        paths[name] = str(d / name)
        cv2.imwrite(paths[name], arr)
    Image.fromarray(bgr[..., ::-1]).convert("P", palette=Image.ADAPTIVE).save(d / "pal.png")
    Image.fromarray(gray > 128).save(d / "bit1.png")
    Image.fromarray(bgr[..., ::-1]).save(d / "inter.png", interlace=1)
    Image.fromarray(np.concatenate([gray[..., None], alpha01], 2), "LA").save(d / "la.png")
    for name in ("pal.png", "bit1.png", "inter.png", "la.png"):
        paths[name] = str(d / name)
    return paths


def test_decode_at_native_size_equals_jax_loader_bit_for_bit(image_files):
    for name, path in image_files.items():
        for channels in (3, 1):
            if name == "bgra.png" and channels == 1:
                continue  # gray of partial alpha: within 1 LSB, below
            ref = native.load_batch([path], (H, W), channels=channels)
            got = image_io.load_batch([path], (H, W), channels)
            np.testing.assert_array_equal(got, ref, err_msg=f"{name} channels={channels}")
    ref = native.load_batch([image_files["bgra.png"]], (H, W), channels=1)
    got = image_io.load_batch([image_files["bgra.png"]], (H, W), 1)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("size", [(24, 32), (80, 70), (18, 106)])
def test_decode_with_resize_against_jax_loader_and_numpy(image_files, size):
    """Resized: equal to the numpy plain version of the same resize, bit for
    bit; masks (nearest) equal to the JAX loader's. The JAX loader is built
    with -march=native, which fuses the bilinear weights into FMAs, so on a
    rounding tie it may land 1 LSB away (the port's build keeps them
    unfused): <= 1 LSB on at most 0.1% of values."""
    for name, path in image_files.items():
        native_img = image_io.load_image(path, 3)
        got = image_io.load_batch([path], size, 3)[0]
        np.testing.assert_array_equal(got, image_io.resize_bilinear_plain(native_img, size))
        ref = native.load_batch([path], size, channels=3)[0]
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        mask = image_io.load_batch([path], size, 1, nearest=True)[0]
        ref = native.load_batch([path], size, 1, nearest=True)[0]
        if name == "bgra.png":  # gray of partial alpha: within 1 LSB, above
            assert np.abs(mask.astype(int) - ref.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(mask, ref, err_msg=name)
        np.testing.assert_array_equal(
            mask, image_io.resize_nearest_plain(image_io.load_image(path, 1)[..., None], size))


def test_resizes_equal_their_numpy_versions():
    rng = np.random.default_rng(1)
    for _ in range(60):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 70, 4))
        c = int(rng.choice([1, 3]))
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        np.testing.assert_array_equal(image_io.resize(img, (oh, ow)),
                                      image_io.resize_bilinear_plain(img, (oh, ow)))
        np.testing.assert_array_equal(image_io.resize(img, (oh, ow), nearest=True),
                                      image_io.resize_nearest_plain(img, (oh, ow)))


def test_plain_bilinear_rounds_half_away_from_zero():
    # 1x2 -> 1x1: the mean of 2 and 3 is 2.5, which np.round would take to 2
    img = np.array([[[2], [3]]], np.uint8)
    assert image_io.resize_bilinear_plain(img, (1, 1))[0, 0, 0] == 3
    assert image_io.resize(img, (1, 1))[0, 0, 0] == 3


def test_written_png_decodes_with_cv2(tmp_path):
    rng = np.random.default_rng(2)
    for shape in ((H, W, 3), (H, W), (1, 1, 3), (5, 300)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / "x.png")
        image_io.write_png(path, img)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back, img)
        np.testing.assert_array_equal(image_io.load_image(path, 3 if img.ndim == 3 else 1), img)


def test_written_jpeg_equals_cv2_quality_95(tmp_path):
    """Measured bound: 0. The port's encoder (libjpeg, quality 95, 4:2:0)
    writes the same bytes as cv2.imwrite's default on these inputs."""
    rng = np.random.default_rng(3)
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (64, 48, 3), dtype=np.uint8), (7, 7), 2)
    for img in (rng.integers(0, 256, (H, W, 3), dtype=np.uint8), smooth, smooth[..., 1]):
        ours, theirs = str(tmp_path / "ours.jpg"), str(tmp_path / "cv2.jpg")
        image_io.write_jpg(ours, img)
        cv2.imwrite(theirs, img)
        flag = cv2.IMREAD_COLOR if img.ndim == 3 else cv2.IMREAD_GRAYSCALE
        diff = np.abs(cv2.imread(ours, flag).astype(int) - cv2.imread(theirs, flag).astype(int))
        assert diff.max() <= 0


def test_probe_and_missing_path(image_files, tmp_path):
    assert image_io.probe(image_files["bgr.png"]) == (H, W, 3)
    assert image_io.probe(image_files["gray.png"]) == (H, W, 1)
    assert image_io.probe(image_files["bgra.png"]) == (H, W, 4)
    assert image_io.probe(image_files["pal.png"]) == (H, W, 3)
    assert image_io.probe(image_files["c.jpg"]) == (H, W, 3)
    missing = str(tmp_path / "missing.png")
    with pytest.raises(OSError, match="missing.png"):
        image_io.probe(missing)
    with pytest.raises(OSError, match="missing.png"):
        image_io.load_batch([image_files["bgr.png"], missing], (16, 16))
    (tmp_path / "junk.png").write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    _, status, sizes = image_io.decode_batch(
        [image_files["bgr.png"], str(tmp_path / "junk.png"), missing], (8, 8))
    assert status[0] == 0 and status[1] != 0 and status[2] != 0
    assert sizes[0].tolist() == [H, W] and sizes[1].tolist() == [0, 0]


def test_union_masks(rng):
    ms = rng.integers(0, 255, (5, 16, 16), dtype=np.uint8)
    np.testing.assert_array_equal(image_io.union_masks(ms),
                                  (ms > 127).any(axis=0).astype(np.uint8) * 255)


def test_resize_prob_matches_cv2():
    m = np.random.default_rng(4).random((32, 32)).astype(np.float32)
    for h, w in ((16, 16), (64, 48), (45, 37)):
        np.testing.assert_allclose(image_io.resize_prob(m, h, w),
                                   cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR),
                                   atol=1e-5)


# ---- datasets and pipelines ----

def _folder(root, layout, n=9, size=(40, 44), ext=".png"):
    rng = np.random.default_rng(5)
    img_dir = root / ("images" if layout == "generic" else "image")
    mask_dir = root / "masks" / "0" if layout == "generic" else root / "mask"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    for i in range(n):
        img = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        mask = (rng.random(size) > 0.5).astype(np.uint8) * 255
        cv2.imwrite(str(img_dir / f"im{i}{ext}"), img)
        suffix = "" if layout == "generic" else "_segmentation"
        cv2.imwrite(str(mask_dir / f"im{i}{suffix}.png"), mask)
    ids = [f"im{i}" for i in range(n)]
    mask_root = root / "masks" if layout == "generic" else mask_dir
    return ids, str(img_dir), str(mask_root)


@pytest.mark.parametrize("layout,ext", [("generic", ".png"), ("isic", ".jpg")])
def test_load_all_equals_jax(tmp_path, layout, ext):
    ids, img_dir, mask_dir = _folder(tmp_path, layout, ext=ext)
    port_cls, jax_cls = (SegmentationFolderDataset, JaxFolder) if layout == "generic" \
        else (ISICDataset, JaxISIC)
    port = port_cls(ids, img_dir, mask_dir, ext, ".png", 1)
    jax_ds = jax_cls(ids, img_dir, mask_dir, ext, ".png", 1)
    for size in ((40, 44), None):  # the files' own size: no resize, bit for bit
        got, want = port.load_all(size), jax_ds.load_all(size)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] == ids
    got, want = port.load_all((32, 32)), jax_ds.load_all((32, 32))
    np.testing.assert_array_equal(got[1], want[1])  # nearest: exact
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1  # see above
    img, mask, img_id = port.load_raw(3)
    assert img.shape == (40, 44, 3) and mask.shape == (40, 44, 1) and img_id == "im3"


def test_host_loader_batches_equal_device_store_gathers(tmp_path):
    ids, img_dir, mask_dir = _folder(tmp_path, "generic", n=11, size=(24, 24))
    ds = SegmentationFolderDataset(ids, img_dir, mask_dir, ".png", ".png", 1)
    imgs, msks, _ = ds.load_all((16, 16))
    store = DeviceDataStore(imgs, msks, "cpu")
    rng_a, rng_b = np.random.default_rng(123), np.random.default_rng(123)
    loader = HostPrefetchLoader(ds, 4, (16, 16), shuffle=True, drop_last=True, rng=rng_b)
    for _ in range(2):
        dev = [(store.images[torch.from_numpy(idx)].numpy(),
                store.masks[torch.from_numpy(idx)].numpy(), valid)
               for idx, valid in epoch_batches(len(store), 4, rng_a, True, True)]
        host = list(loader)
        assert len(dev) == len(host) == 2
        for (di, dm, dv), (hi, hm, hv) in zip(dev, host):
            assert dv == hv
            np.testing.assert_array_equal(di, hi)
            np.testing.assert_array_equal(dm, hm)
    val = HostPrefetchLoader(ds, 4, (16, 16), shuffle=False, drop_last=False, rng=rng_b)
    assert [v for *_, v in val] == [4, 4, 3]


def test_host_loader_raises_a_decoding_error(tmp_path):
    ids, img_dir, mask_dir = _folder(tmp_path, "generic", n=4, size=(16, 16))
    os.remove(os.path.join(img_dir, "im2.png"))
    ds = SegmentationFolderDataset(ids, img_dir, mask_dir, ".png", ".png", 1)
    with pytest.raises(OSError, match="im2.png"):
        list(HostPrefetchLoader(ds, 2, (16, 16), shuffle=False, drop_last=False))


def test_resolve_pipeline_on_the_cpu(capsys):
    cfg = {"pipeline": "auto", "input_h": 96, "input_w": 96, "input_channels": 3,
           "num_classes": 1}
    assert resolve_pipeline(cfg, 670, "cpu") == "device"
    assert "pipeline auto -> device" in capsys.readouterr().out
    assert resolve_pipeline({**cfg, "pipeline": "host"}, 670, "cpu") == "host"


def test_preprocess_dsb2018_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    src = tmp_path / "stage1_train"
    for k, (h, w) in enumerate(((70, 90), (96, 96), (130, 110))):
        sample = src / f"s{k}"
        (sample / "images").mkdir(parents=True)
        (sample / "masks").mkdir()
        img = np.concatenate([rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                              np.full((h, w, 1), 255, np.uint8)], 2)  # RGBA, as DSB2018's
        cv2.imwrite(str(sample / "images" / f"s{k}.png"), img)
        yy, xx = np.mgrid[0:h, 0:w]
        for j in range(3):
            cy, cx = rng.integers(10, min(h, w) - 10, 2)
            inst = ((yy - cy) ** 2 + (xx - cx) ** 2 < 60).astype(np.uint8) * 255
            cv2.imwrite(str(sample / "masks" / f"m{j}.png"), inst)
    assert preprocess_dsb2018(str(src), str(tmp_path / "port"), 32, verbose=False) == 3
    assert jax_preprocess(str(src), str(tmp_path / "jax"), 32, verbose=False) == 3
    for sub in ("images", os.path.join("masks", "0")):
        for k in range(3):
            got = cv2.imread(str(tmp_path / "port" / "dsb2018_32" / sub / f"s{k}.png"),
                             cv2.IMREAD_UNCHANGED)
            want = cv2.imread(str(tmp_path / "jax" / "dsb2018_32" / sub / f"s{k}.png"),
                              cv2.IMREAD_UNCHANGED)
            assert got.shape == want.shape
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (sub, k)
