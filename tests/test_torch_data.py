"""The port's data layer against the JAX package's, on the CPU.

- ``VideoDecoder``: frames, ``num_frames`` and ``fps`` of a ``.npy`` frame
  array and of a small MJPG ``.avi`` written here with OpenCV, equal; both
  raise without a decode backend.
- ``sample_frame_indices`` in every mode, with and without a generator.
- ``preprocess_clip``: eval mode, and train mode at the offsets and flip
  JAX draws from its key, on shrinking and enlarging shapes, within 1e-4.
- The BPE ``SimpleTokenizer`` on a small merges file, gzipped and plain.
- ``FeatureReader`` on ``.npy``, ``.npz``, zip ``.pt`` (every dtype of
  tests/test_pt_reader.py, bfloat16 widened to float32) and legacy
  ``.pt``; ``load_pt`` refusing a global.
- ``read_files_parallel`` (``csrc/feature_loader.cc``) on
  tests/test_native.py's case, and its error naming a missing file.
- ``PrefetchLoader``: JAX's batch order, and a ``batch_fn`` error raised
  in the consumer within a time limit.
"""

import gzip
import pickle
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.data import features as jax_features
from video_mamba_suite_tpu.data import tokenizer as jax_tokenizer
from video_mamba_suite_tpu.data import video as jax_video
from video_mamba_suite_torch.data import features, pt_reader, tokenizer, video
from video_mamba_suite_torch.ops.native import read_files_parallel

# preprocess_clip: the antialiased bilinear resize against
# jax.image.resize, then the same crop, flip and normalisation, in fp32;
# each value within 1e-4 of JAX's (the normalised values reach about 2)
PREPROCESS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them faster
    and keeps the test workers beside this file from being
    oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_without_most_optimizations():
    """The JAX references compile without most of XLA's optimization
    passes: they are small, and the compile is most of their time."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


# --- decode --------------------------------------------------------------

def test_npy_decode_matches_jax(tmp_path):
    clip = _frames((12, 20, 24, 3), 0)
    path = str(tmp_path / "clip.npy")
    np.save(path, clip)
    got, want = video.VideoDecoder(path), jax_video.VideoDecoder(path)
    assert got.backend == want.backend == "npy"
    assert (got.num_frames, got.fps) == (want.num_frames, want.fps) == \
        (12, 30.0)
    idx = [0, 5, 5, 11, 3]
    np.testing.assert_array_equal(got.get_batch(idx), want.get_batch(idx))
    np.testing.assert_array_equal(got.get_batch(idx), clip[idx])


def test_avi_decode_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                             (48, 32))
    assert writer.isOpened()
    clip = _frames((10, 32, 48, 3), 1)
    for frame in clip:
        writer.write(frame)
    writer.release()
    got, want = video.VideoDecoder(path), jax_video.VideoDecoder(path)
    assert got.backend == want.backend == "cv2"
    assert (got.num_frames, got.fps) == (want.num_frames, want.fps)
    assert got.num_frames == 10 and got.fps == pytest.approx(25.0)
    # index 40 does not read: the last frame repeats, its channels
    # reversed by a second BGR-to-RGB conversion (the JAX quirk)
    idx = [0, 3, 9, 40, 2]
    frames = got.get_batch(idx)
    np.testing.assert_array_equal(frames, want.get_batch(idx))
    assert frames.shape == (5, 32, 48, 3)
    np.testing.assert_array_equal(frames[3], frames[2][..., ::-1])


def test_decoder_without_a_backend_raises(tmp_path, monkeypatch):
    import shutil

    for name in ("decord", "av", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    path = str(tmp_path / "clip.mp4")
    for module in (video, jax_video):
        with pytest.raises(RuntimeError, match="no video decode backend"):
            module.VideoDecoder(path)
    with pytest.raises(NotImplementedError, match="ffmpeg"):
        video.VideoDecoder(path, backend="ffmpeg")


@pytest.mark.parametrize("mode", ["sparse", "uniform"])
def test_sample_frame_indices_match_jax(mode):
    for num_frames, total in ((8, 300), (16, 10), (4, 0), (3, 7)):
        for clip_idx, num_clips in ((0, 1), (2, 4), (3, 4)):
            kw = dict(mode=mode, clip_idx=clip_idx, num_clips=num_clips)
            np.testing.assert_array_equal(
                video.sample_frame_indices(num_frames, total, **kw),
                jax_video.sample_frame_indices(num_frames, total, **kw))
            got = video.sample_frame_indices(
                num_frames, total, rng=np.random.default_rng(7), **kw)
            want = jax_video.sample_frame_indices(
                num_frames, total, rng=np.random.default_rng(7), **kw)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype == np.int64


# (T, H, W) → size: two shrinks and an enlargement
PREPROCESS_SHAPES = [((3, 40, 48), 32), ((2, 60, 80), 24),
                     ((2, 20, 26), 32)]


@pytest.mark.parametrize("shape,size", PREPROCESS_SHAPES,
                         ids=["shrink", "shrink-wide", "enlarge"])
def test_preprocess_clip_matches_jax(shape, size):
    clip = _frames(shape + (3,), 2)
    got = video.preprocess_clip(clip, size=size, device="cpu")
    want = np.asarray(jax_video.preprocess_clip(clip, size=size))
    assert got.shape == want.shape == (shape[0], size, size, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PREPROCESS_TOL)
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_video.preprocess_clip(clip, key, size=size,
                                                    train=True))
        # the offsets and the flip JAX draws from its key
        k1, k2, k3 = jax.random.split(key, 3)
        new_h, new_w = video._scaled_shape(shape[1], shape[2], size, True)
        top = int(jax.random.randint(k1, (), 0, new_h - size + 1))
        left = int(jax.random.randint(k2, (), 0, new_w - size + 1))
        flip = bool(jax.random.bernoulli(k3))
        got = video._preprocess_clip_at(clip, size, True, top, left, flip,
                                        video.CLIP_MEAN, video.CLIP_STD,
                                        "cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=PREPROCESS_TOL)


def test_preprocess_clip_train_draws_from_its_generator():
    clip = _frames((2, 40, 48, 3), 4)
    outs = [video.preprocess_clip(clip, torch.Generator().manual_seed(s),
                                  size=32, train=True, device="cpu")
            for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == (2, 32, 32, 3)
    assert torch.isfinite(outs[2]).all()


# --- the BPE tokenizer -----------------------------------------------------

MERGES = ["t h", "th e</w>", "p e", "pe r", "per s", "o n</w>",
          "pers on</w>", "d o", "do e", "doe s</w>", "a n", "an d</w>",
          "c a", "ca f", "Ã ©", "caf Ã©</w>", "i n", "in g</w>", "t i",
          "ti m", "tim e", "time s</w>"]
TEXTS = ["A person does the thing, 3 times!",
         "  café &amp;amp; the   person's DOG  ",
         "<|startoftext|>and then",
         "word " * 60]


@pytest.mark.parametrize("gz", [True, False], ids=["gzip", "plain"])
def test_bpe_tokenizer_matches_jax(tmp_path, gz):
    text = "#version: 0.2\n" + "\n".join(MERGES) + "\n"
    path = tmp_path / ("merges.txt.gz" if gz else "merges.txt")
    if gz:
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(text)
    else:
        path.write_text(text, encoding="utf-8")
    got = tokenizer.SimpleTokenizer(str(path), context_length=16)
    want = jax_tokenizer.SimpleTokenizer(str(path), context_length=16)
    assert got.encoder == want.encoder and got.bpe_ranks == want.bpe_ranks
    for t in TEXTS:
        assert got.encode(t) == want.encode(t), t
    np.testing.assert_array_equal(got(TEXTS), want(TEXTS))
    np.testing.assert_array_equal(
        tokenizer.tokenize(TEXTS[0], got, 77),
        jax_tokenizer.tokenize(TEXTS[0], want, 77))
    assert tokenizer.bytes_to_unicode() == jax_tokenizer.bytes_to_unicode()
    assert tokenizer.basic_clean(TEXTS[1]) == \
        jax_tokenizer.basic_clean(TEXTS[1])
    assert tokenizer.get_pairs(("a", "b", "c")) == \
        jax_tokenizer.get_pairs(("a", "b", "c"))


# --- feature readers -----------------------------------------------------

PT_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
             torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
             torch.bool]


def _read_both(root, name, ext):
    got = features.FeatureReader(str(root), ext=ext)(name)
    want = jax_features.FeatureReader(str(root), ext=ext)(name)
    return np.asarray(got), np.asarray(want)


def test_feature_reader_npy_npz_match_jax(tmp_path):
    feats = np.random.default_rng(5).standard_normal((16, 7)).astype(
        np.float32)
    np.save(tmp_path / "a.npy", feats)
    np.savez(tmp_path / "b.npz", features=feats)
    for name, ext in (("a", ".npy"), ("b", ".npz")):
        got, want = _read_both(tmp_path, name, ext)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, feats)
    reader = features.FeatureReader(str(tmp_path), ext=".npy",
                                    cache_size=1)
    assert reader("a") is reader("a")
    with pytest.raises(ValueError, match="unknown feature ext"):
        features.FeatureReader(str(tmp_path), ext=".h5")("a")


@pytest.mark.parametrize("dtype", PT_DTYPES,
                         ids=lambda d: str(d).split(".")[-1])
def test_feature_reader_pt_matches_jax(tmp_path, dtype):
    t = (torch.arange(24).reshape(2, 3, 4) % 5 - 2).to(dtype)
    torch.save(t, str(tmp_path / "zip.pt"))
    assert pt_reader.is_zip_pt(str(tmp_path / "zip.pt"))
    got, want = _read_both(tmp_path, "zip", ".pt")
    if dtype == torch.bfloat16:     # widened to float32, exactly
        assert got.dtype == np.float32
        want = np.asarray(want, np.float32)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_feature_reader_legacy_pt_matches_jax(tmp_path):
    t = torch.randn(32, 6, generator=torch.Generator().manual_seed(6))
    torch.save(t, str(tmp_path / "old.pt"),
               _use_new_zipfile_serialization=False)
    assert not pt_reader.is_zip_pt(str(tmp_path / "old.pt"))
    got, want = _read_both(tmp_path, "old", ".pt")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t.numpy())


def test_load_pt_nesting_and_refusing_a_global(tmp_path):
    lin = torch.nn.Linear(4, 3)
    obj = {"state": lin.state_dict(), "meta": {"epoch": 3, "name": "run"},
           "arrs": [torch.ones(2), torch.zeros(3).to(torch.bfloat16)]}
    torch.save(obj, str(tmp_path / "ckpt.pt"))
    got = pt_reader.load_pt(str(tmp_path / "ckpt.pt"))
    np.testing.assert_array_equal(got["state"]["weight"],
                                  lin.weight.detach().numpy())
    assert got["meta"] == obj["meta"]
    assert got["arrs"][1].dtype == np.float32
    torch.save({"x": pickle.PicklingError("x")}, str(tmp_path / "bad.pt"))
    with pytest.raises(pickle.UnpicklingError):
        pt_reader.load_pt(str(tmp_path / "bad.pt"))


# --- the native reader ---------------------------------------------------

def test_read_files_parallel(tmp_path):
    datas = [np.arange(i + 4, dtype=np.float32).tobytes() for i in range(5)]
    paths = []
    for i, d in enumerate(datas):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(d)
        paths.append(str(p))
    sizes = [len(d) for d in datas]
    out = read_files_parallel(paths, sizes, num_threads=3)
    assert out.dtype == np.uint8 and out.tobytes() == b"".join(datas)
    start = sum(sizes[:2])
    np.testing.assert_array_equal(
        np.frombuffer(out[start:start + sizes[2]].tobytes(), np.float32),
        np.arange(6, dtype=np.float32))
    # a header skipped in every file
    out = read_files_parallel(paths, [s - 8 for s in sizes], header_skip=8)
    assert out.tobytes() == b"".join(d[8:] for d in datas)
    missing = str(tmp_path / "missing.bin")
    with pytest.raises(OSError, match="missing.bin"):
        read_files_parallel(paths[:2] + [missing], sizes[:3])
    with pytest.raises(OSError, match="f1.bin"):       # too few bytes
        read_files_parallel(paths[:2], [sizes[0], sizes[1] + 1])


# --- the prefetch loader -------------------------------------------------

def _batch(i):
    time.sleep(0.002 * ((7 * i) % 5))     # finish out of order
    return {"x": np.full((2, 3), i, np.float32), "meta": [np.arange(i + 1)]}


def test_prefetch_loader_order_matches_jax():
    got = list(features.PrefetchLoader(_batch, 9, num_workers=3,
                                       device="cpu"))
    want = list(jax_features.PrefetchLoader(_batch, 9, num_workers=3))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert isinstance(g["x"], torch.Tensor)
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(w["x"]))
        np.testing.assert_array_equal(g["meta"][0].numpy(),
                                      np.asarray(w["meta"][0]))
    host = list(features.PrefetchLoader(_batch, 4, device_put=False))
    assert [int(b["x"][0, 0]) for b in host] == [0, 1, 2, 3]
    with pytest.raises(NotImplementedError, match="item 10"):
        features.PrefetchLoader(_batch, 4, sharding=object())


def test_prefetch_loader_raises_a_batch_fn_error():
    def batch_fn(i):
        if i == 1:
            raise ValueError("batch 1 is broken")
        return np.full(2, i)

    result = {}

    def consume():
        try:
            result["batches"] = list(features.PrefetchLoader(
                batch_fn, 4, num_workers=2, device="cpu"))
        except ValueError as e:
            result["error"] = e

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "the loader hangs"
    assert "batches" not in result
    assert str(result["error"]) == "batch 1 is broken"
