"""The port's native image decoder (``madm_torch/data/native.py``) against the
JAX package's (``madm_tpu/data/native.py``) over the same
``native/madm_data.cpp``: decode, resize, crop / flip and nearest labels
bit for bit; the port's dataset samples equal to the JAX package's with
both decoders native and with both on PIL; and the port's build, which
goes to its own directory and never to ``native/libmadm_data.so``."""

import json
import subprocess
import time

import numpy as np
import pytest
from PIL import Image

import madm_tpu.data.native as jax_native
import madm_torch.data.native as port_native
from madm_tpu.data import CrossModalityDataset as JaxDataset
from madm_torch.data import CrossModalityDataset
from madm_torch.data.dataset import IGNORE_LABEL


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's library, loaded.  Its unlocked first build can
    race another process's build of the same file (ROADMAP §C), so a
    failed first try is retried once the other build has had time to end;
    this reads the JAX package's load state, it does not rebuild for it."""
    for attempt in range(4):
        if jax_native.available():
            return jax_native
        time.sleep(5)
        jax_native._tried = False
    raise AssertionError("the JAX package's native library did not load")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    lbl = rng.integers(0, 20, (60, 80), dtype=np.uint8)
    lbl[0] = 255
    out = {"rgb": (d / "t.png", rgb), "lbl": (d / "l.png", lbl), "gray": (d / "g.png", lbl * 10)}
    for path, arr in out.values():
        Image.fromarray(arr).save(path)
    rgb_jpg = d / "t.jpg"
    Image.fromarray(rgb).save(rgb_jpg, quality=90)
    out["jpg"] = (rgb_jpg, None)
    return {k: str(p) for k, (p, _) in out.items()}, {k: a for k, (_, a) in out.items()}


CASES = {
    "decode": dict(),
    "shrink": dict(resize_wh=(40, 32)),
    "grow": dict(resize_wh=(160, 120)),
    "crop_flip": dict(resize_wh=(80, 60), crop=(10, 5, 32, 24), flip=True),
    "crop": dict(crop=(3, 7, 50, 41)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_bit_equal_to_jax(case, images, jax_lib):
    paths, arrays = images
    assert port_native.available()
    for name in ("rgb", "jpg", "gray"):
        got = port_native.load(paths[name], **CASES[case])
        np.testing.assert_array_equal(got, jax_lib.load(paths[name], **CASES[case]), err_msg=name)
    if case == "decode":
        np.testing.assert_array_equal(port_native.load(paths["rgb"]), arrays["rgb"])
        assert port_native.image_size(paths["rgb"]) == jax_lib.image_size(paths["rgb"]) == (80, 60, 3)
        g = port_native.load(paths["gray"], out_c=3)
        np.testing.assert_array_equal(g[..., 0], g[..., 2])


@pytest.mark.parametrize("case", ["decode", "shrink", "grow", "crop_flip"])
def test_nearest_labels_bit_equal_to_jax_and_pil(case, images, jax_lib):
    paths, arrays = images
    kw = CASES[case]
    got = port_native.load(paths["lbl"], nearest=True, out_c=1, **kw)
    np.testing.assert_array_equal(got, jax_lib.load(paths["lbl"], nearest=True, out_c=1, **kw))
    img = Image.fromarray(arrays["lbl"])
    if "resize_wh" in kw:
        img = img.resize(kw["resize_wh"], Image.NEAREST)
    if "crop" in kw:
        x, y, w, h = kw["crop"]
        img = img.crop((x, y, x + w, y + h)).transpose(Image.FLIP_LEFT_RIGHT)
    np.testing.assert_array_equal(got[..., 0], np.array(img))


def test_unreadable_file_raises(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(IOError):
        port_native.load(str(bad))


def _write_dataset(root, deliver=False):
    rng = np.random.default_rng(1)
    train = {"source_data": {"RGB": [], "label": []}, "target_data": {"second_modality": []}}
    test = {"source_data": {"RGB": [], "label": []}, "target_data": {"second_modality": [], "label": []}}
    for i in range(2):
        lbl = rng.integers(0, 11, (64, 96), dtype=np.uint8)
        lbl[:3] = IGNORE_LABEL
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(root / f"src{i}.png")
        Image.fromarray(np.stack([lbl] * 3, -1) if deliver else lbl).save(root / f"lbl{i}.png")
        Image.fromarray(rng.integers(0, 256, (64, 96), dtype=np.uint8)).save(root / f"tgt{i}.png")
        train["source_data"]["RGB"].append(f"src{i}.png")
        train["source_data"]["label"].append(f"lbl{i}.png")
        train["target_data"]["second_modality"].append(f"tgt{i}.png")
        test["target_data"]["second_modality"].append(f"tgt{i}.png")
        test["target_data"]["label"].append(f"lbl{i}.png")
    name = "DELIVER_RGB2Depth" if deliver else "plain"
    for mode, manifest in (("train", train), ("test", test)):
        (root / f"{name}_{mode}.json").write_text(json.dumps(manifest))
    return name


def _kwargs(root, name, mode):
    common = dict(json_path=str(root / f"{name}_{mode}.json"), source_root_path=str(root),
                  target_root_path=str(root), train_or_test=mode, seed=0)
    if mode == "train":
        return dict(common, source_resize_h_w=[60, 90], source_crop_size_h_w=[48, 64],
                    target_resize_h_w=[70, 100], target_crop_size_h_w=[48, 64])
    return dict(common, test_resize_h_w=[48, 80])


@pytest.mark.parametrize("decoder", ["native", "PIL"])
@pytest.mark.parametrize("deliver", [False, True])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_dataset_samples_equal_jax(decoder, deliver, mode, tmp_path, jax_lib, monkeypatch):
    """Both packages' datasets on the same decoder give the same samples
    (with the DELIVER label shift on 3-channel labels too); the port logs
    its decoder."""
    if decoder == "PIL":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
    name = _write_dataset(tmp_path, deliver)
    port = CrossModalityDataset(**_kwargs(tmp_path, name, mode))
    ref = JaxDataset(**_kwargs(tmp_path, name, mode))
    assert port.deliver_label_process == deliver
    assert port_native.decoder_name() == decoder
    for i in range(len(port)):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    if deliver:  # ids 0..10 shifted to -1..9, 255 kept
        labels = [v for i in range(len(port)) for v in port[i].values()
                  if isinstance(v, np.ndarray) and v.dtype == np.int32]
        assert labels
        assert all(lbl.min() == -1 and set(np.unique(lbl)) <= set(range(-1, 10)) | {IGNORE_LABEL}
                   for lbl in labels)


def test_port_builds_into_its_own_directory(tmp_path, monkeypatch):
    """A fresh build goes, through a file of its own renamed under the
    lock, to the port's build directory, named by the hash of the source and
    flags; no command names ``native/libmadm_data.so``, whose state the
    port's use leaves as it was."""
    jax_lib_path = port_native.REPO_ROOT / "native" / "libmadm_data.so"
    assert port_native.library_path().parent == port_native.REPO_ROOT / "build" / "madm_torch"
    assert port_native.library_path() != jax_lib_path
    calls = []
    real_run = subprocess.run

    def run(cmd, *a, **kw):
        calls.append(list(cmd))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_native.subprocess, "run", run)
    out = port_native.build()
    assert out.parent == tmp_path and out.name.startswith("libmadm_data-") and out.exists()
    builds = [c for c in calls if port_native.CXX in c[0] and "-o" in c]
    assert len(builds) == 1
    target = builds[0][builds[0].index("-o") + 1]
    assert target.startswith(str(tmp_path)) and target.endswith(".tmp")
    assert all(str(jax_lib_path) not in arg for c in calls for arg in c)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([out.name, "libmadm_data.lock"])
    assert port_native.build() == out and len(calls) == 1  # cached: no second build
