"""tpusr's orbax checkpoint directories in the port, on the CPU.

* zstd: the port's decoder (tpusr_torch/native/zstd.cc) equals
  ``zstandard`` on frames at levels -5, 1, 3, 19 and 22 (long mode off),
  0 B to a few MB of random, run-length, text-like and mixed data, with and
  without a checksum or content size, several blocks, concatenated and
  skippable frames, and on random bytes at random levels (hypothesis).
* OCDBT: ``OcdbtStore`` lists and reads what tensorstore lists and reads
  in stores written by tensorstore itself: compressed and not, B-trees of
  several levels (small nodes), version trees of several levels (arity 2),
  values inline and in data files; tensorstore's 'numbered' manifest kind,
  which orbax does not write, raises.
* zarr: several chunks with cut edge chunks and missing chunks read as
  the fill value, written by tensorstore's zarr v2 support; every dtype the
  port writes round-trips.
* orbax: ``read_tree`` equals tpusr's ``load_checkpoint`` bit for bit on
  trees tpusr's ``save_checkpoint`` wrote (f32, bf16, i32, 0-d, leaves
  small enough to sit inline in a B-tree node and large ones, nested dicts
  and tuples, None; a whole 2-block GANTrainState under d_moments 'bf16'
  and 'f32'); tpusr's ``load_checkpoint`` restores what ``write_tree`` and
  ``save_train_state`` write, with and without a target. orbax 0.11.32
  splits an array into several chunks only past its OCDBT target data
  file size, 2 GiB, so a tpusr checkpoint of this repo holds one chunk per
  leaf; the several-chunk case is tensorstore's own above.
* The committed fixture (tests/data/orbax_tpusr_small, written once by
  tpusr's ``save_checkpoint``; ``write_fixture`` below) holds the values
  ``fixture_tree`` defines, in both packages' readers.
* The CLIs both ways: the port's train CLI resumes a tpusr run directory
  (--resume, --pre_trained_models_path), tpusr's resumes the port's, and
  one training step from each resumed state matches the other package's
  step within tests/test_torch_gan_train.py's tolerances; the port's eval
  CLI takes a tpusr orbax --model_path, within
  tests/test_torch_cli_eval_gan.py's 1e-4 of tpusr's eval and bit-equal to
  the port's .pth route.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tests.test_torch_gan_train import _compare, _port_flat, _strong
from tpusr.cli import eval_gan as jax_eval_cli
from tpusr.cli import train_gan as jax_train_cli
from tpusr.engine import gan as jg
from tpusr.engine import losses as JL
from tpusr.io.checkpoint import load_checkpoint, save_checkpoint
from tpusr_torch import native
from tpusr_torch.cli import eval_gan, train_gan
from tpusr_torch.engine import gan as pg
from tpusr_torch.io.checkpoint import load_train_state, save_train_state
from tpusr_torch.io.ocdbt import FormatError, OcdbtStore
from tpusr_torch.io.orbax import cast_like, read_tree, write_tree
from tpusr_torch.io.weights import export_flax_gan_state, load_flax_gan_state
from tpusr_torch.io.zarr import DirStore, read_array, write_array
from tpusr_torch.native import zstd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_tpusr_small")
FIXTURE_SEED = 20261017
LR = 1e-6  # tests/test_torch_gan_train.py's step rate and tolerances
CLI = dict(factor=8, batch_size=2, hr_patch=32, residual_blocks_count=2)
TINY = ["--residual_blocks", "2", "--hr_patch_size", "32", "--batch_size",
        "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _bits(t) -> np.ndarray:
    """A leaf's bytes, for bit-for-bit comparison (numpy, jax or torch)."""
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.contiguous().numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(t)).reshape(-1).view(np.uint8)


def _dtype(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def _assert_same_tree(got, want, where=""):
    """``got`` (the port's tensors) equals ``want`` (tpusr's restore, a
    dict/list/tuple tree) in structure, shapes, dtypes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_tree(a, b, f"{where}/{i}")
    elif want is None:
        assert got is None, where
    else:
        assert tuple(got.shape) == np.shape(want), where
        assert _dtype(got) == _dtype(want), (where, _dtype(got))
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=where)


def _state_dict_tree(js):
    """tpusr's GANTrainState as the plain tree orbax restores without a
    target."""
    out = {f: getattr(js, f) for f in ("params_G", "stats_G", "params_D",
                                       "stats_D", "step")}
    for f in ("opt_G", "opt_D"):
        adam = getattr(js, f)[0]
        out[f] = [{"count": adam.count, "mu": adam.mu, "nu": adam.nu}, None]
    return out


# ---------------------------------------------------------------------------
# zstd


def _payloads():
    rng = np.random.default_rng(0)
    words = [b"the", b"quick", b"checkpoint", b"tensor", b"\n", b" ", b"zstd",
             b"orbax", b"0.0", b"{\"dtype\": \"<f4\"}"]
    yield "empty", b""
    yield "one", b"a"
    yield "random", rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    yield "runs", np.repeat(rng.integers(0, 4, 30_000, dtype=np.uint8),
                            rng.integers(1, 40, 30_000)).tobytes()
    yield "text", b"".join(words[i] for i in rng.integers(0, 10, 200_000))
    yield "floats", (rng.standard_normal(300_000) * 0.02).astype(
        np.float32).tobytes()
    yield "mixed", b"".join(
        [rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
         b"abc" * 20_000, (np.arange(50_000) % 251).astype(np.uint8).tobytes(),
         bytes(100_000)])
    yield "zeros_mb", bytes(3 << 20)
    yield "floats_mb", rng.standard_normal(1 << 20).astype(np.float32
                                                           ).tobytes()


@pytest.mark.parametrize("level", [-5, 1, 3, 19, 22])
def test_zstd_matches_zstandard(level):
    for name, data in _payloads():
        if level >= 19:
            data = data[:150_000]  # the encoder's time, not the decoder's
        for size, check in ((True, True), (False, False), (True, False)):
            frame = zstandard.ZstdCompressor(
                level=level, write_content_size=size,
                write_checksum=check).compress(data)
            got = zstd.decompress(frame)
            assert got.dtype == np.uint8
            assert got.tobytes() == data, (name, level, size, check)


def test_zstd_frames_and_errors():
    one = zstandard.ZstdCompressor(level=3).compress(b"hello " * 100)
    two = zstandard.ZstdCompressor(level=3, write_content_size=False,
                                   write_checksum=True).compress(b"world" * 9)
    skip = (0x184D2A5E).to_bytes(4, "little") + (3).to_bytes(4, "little") \
        + b"xyz"
    assert zstd.decompress(skip + one + skip + two + skip).tobytes() == \
        b"hello " * 100 + b"world" * 9
    bad = bytearray(two)
    bad[-1] ^= 1  # the XXH64 checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    assert zstd.decompress(bytes(bad), verify_checksum=False).tobytes() == \
        b"world" * 9
    for junk, why in ((b"", "no frame"), (b"abcd", "magic"),
                      (one[:-3], "past the input"),
                      (one[:4] + bytes([one[4] | 8]) + one[5:], "reserved")):
        with pytest.raises(ValueError, match=why):
            zstd.decompress(junk)
    # a dictionary frame: descriptor with a 1-byte dictionary id
    with pytest.raises(ValueError, match="dictionar"):
        zstd.decompress(one[:4] + bytes([0x21, 7]) + one[5:])
    assert zstd.crc32c(b"123456789") == 0xE3069283  # RFC 3720 B.4
    assert zstd.crc32c(b"") == 0


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=20_000), st.sampled_from([-3, 1, 5, 12, 19]),
       st.integers(1, 4))
def test_zstd_random_bytes(data, level, repeat):
    data = data * repeat
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(frame).tobytes() == data


def test_a_failed_build_raises_with_the_compiler_message(tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build_library(str(src), "broken-test")


# ---------------------------------------------------------------------------
# OCDBT


def _ts_store(path, config, generations=4, per=25):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config}).result()
    rng = np.random.default_rng(1)
    for g in range(generations):
        with ts.Transaction() as txn:
            for i in range(per):
                n = int(rng.integers(0, 40))
                kv.with_transaction(txn)[f"leaf{g % 3}.k{i:03d}/{g}"] = \
                    rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return kv


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 8,
     "version_tree_arity_log2": 1, "compression": {"id": "zstd"}},
    {"max_inline_value_bytes": 16, "compression": None},
], ids=["deep-zstd", "raw"])
def test_ocdbt_matches_tensorstore(tmp_path, config):
    kv = _ts_store(str(tmp_path), config)
    store = OcdbtStore(str(tmp_path))
    keys = [bytes(k) for k in kv.list().result()]
    assert store.list() == sorted(keys)
    assert store.list("leaf1.") == sorted(k for k in keys
                                          if k.startswith(b"leaf1."))
    for k in keys:
        assert store.get(k) == kv.read(k).result().value, k
    assert store.get(b"absent") is None
    dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()
                         ).result()
    assert [v.generation for v in store.versions] == [
        v["generation_number"] for v in dump["versions"]]
    assert [v.generation for v in store.history()] == list(
        range(1, store.version.generation + 1))
    if config.get("max_decoded_node_bytes") == 300:
        assert store.version.root_height >= 2  # interior nodes were read
        assert store.version_nodes  # and version-tree nodes


def test_ocdbt_numbered_manifest_raises(tmp_path):
    _ts_store(str(tmp_path), {"manifest_kind": "numbered"}, generations=1)
    with pytest.raises(FormatError, match="manifest kind at byte 16: 1"):
        OcdbtStore(str(tmp_path))


def _resign(data: bytes) -> bytes:
    return data[:-4] + zstd.crc32c(data[:-4]).to_bytes(4, "little")


def test_ocdbt_unknown_fields_raise(tmp_path):
    _ts_store(str(tmp_path), {"compression": None}, generations=1)
    path = tmp_path / "manifest.ocdbt"
    good = path.read_bytes()
    cases = [
        (bytearray(good), 20, 0xFF, "checksum at byte"),
        (bytearray(good), 0, 0x0D, "magic at byte 0"),
        (bytearray(good), 13, 5, "compression format at byte 13"),
        (bytearray(good), 14 + 16, 7, "manifest kind at byte 16"),
    ]
    for data, at, value, why in cases:
        data[at] = value
        path.write_bytes(bytes(data) if why.startswith("checksum")
                         else _resign(bytes(data)))
        with pytest.raises(FormatError, match=why):
            OcdbtStore(str(tmp_path))
    path.write_bytes(good)
    store = OcdbtStore(str(tmp_path))
    (node,) = {os.path.join(tmp_path, store.version.root.path)}
    raw = bytearray(open(node, "rb").read())
    off = store.version.root.offset
    raw[off + 14] = 3  # the root's height byte
    raw[off:off + store.version.root.length] = _resign(
        bytes(raw[off:off + store.version.root.length]))
    open(node, "wb").write(bytes(raw))
    with pytest.raises(FormatError, match="height at byte 0: 3"):
        OcdbtStore(str(tmp_path)).list()


# ---------------------------------------------------------------------------
# zarr


@pytest.mark.parametrize("dtype,compressor,kvstore", [
    ("<f4", {"id": "zstd", "level": 3}, "ocdbt"),
    ("<i4", None, "file"),
    ("bfloat16", {"id": "zstd", "level": 1}, "file"),
], ids=["f32-zstd-ocdbt", "i32-raw-file", "bf16-zstd-file"])
def test_zarr_chunks_edges_and_fill(tmp_path, dtype, compressor, kvstore):
    base = {"driver": "file", "path": f"{tmp_path}/"}
    kv = {"driver": "ocdbt", "base": base} if kvstore == "ocdbt" else base
    arr = ts.open({"driver": "zarr", "kvstore": kv, "path": "x.y",
                   "metadata": {"shape": [7, 10], "chunks": [3, 4],
                                "dtype": dtype, "compressor": compressor,
                                "fill_value": 5, "dimension_separator": "."}},
                  create=True).result()
    rng = np.random.default_rng(2)
    vals = (rng.standard_normal((7, 10)) * 50).astype(np.float32)
    arr[0:6, 0:8] = vals[0:6, 0:8].astype(arr.dtype.numpy_dtype)
    arr[6:7, 8:10] = vals[6:7, 8:10].astype(arr.dtype.numpy_dtype)
    want = arr.read().result()
    store = OcdbtStore(str(tmp_path)) if kvstore == "ocdbt" \
        else DirStore(str(tmp_path))
    got = read_array(store, "x.y")
    assert tuple(got.shape) == (7, 10)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # chunk (1, 2) (rows 3-5, cols 8-9) was never written: the fill value
    assert float(got[3, 9]) == 5.0 and store.get("x.y/1.2") is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint32, torch.bool])
def test_zarr_write_read_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(3)
    for shape in ((), (5,), (2, 3, 4)):
        t = (torch.randn(shape, generator=g) * 1000).to(dtype) \
            if dtype != torch.uint32 else torch.randint(
                0, 1 << 31, shape, generator=g).to(torch.int64).to(dtype)
        write_array(str(tmp_path / "a"), t)
        got = read_array(DirStore(str(tmp_path)), "a")
        assert got.dtype == dtype and got.shape == t.shape
        np.testing.assert_array_equal(_bits(got), _bits(t))
        shutil.rmtree(tmp_path / "a")


def test_zarr_refuses_what_it_does_not_read(tmp_path):
    write_array(str(tmp_path / "a"), torch.ones(3))
    meta = json.loads((tmp_path / "a" / ".zarray").read_text())
    for change, why in (({"dtype": "<f8"}, "dtype"),
                        ({"fill_value": "NaN"}, "fill_value"),
                        ({"compressor": {"id": "blosc"}}, "compressor"),
                        ({"order": "F"}, "order"),
                        ({"filters": [{"id": "delta"}]}, "filters")):
        (tmp_path / "a" / ".zarray").write_text(json.dumps({**meta,
                                                            **change}))
        with pytest.raises(ValueError, match=why):
            read_array(DirStore(str(tmp_path)), "a")


# ---------------------------------------------------------------------------
# orbax trees


def _mixed_tree():
    rng = np.random.default_rng(4)
    return {
        "f32": jnp.asarray(rng.standard_normal((4, 5)), jnp.float32),
        "bf16": jnp.asarray(rng.standard_normal((33, 7)), jnp.bfloat16),
        "i32": jnp.asarray(rng.integers(-9, 9, (6,)), jnp.int32),
        "scalar": jnp.asarray(3, jnp.int32),
        "tiny": jnp.asarray([1.5], jnp.float32),  # inline in the node
        "large": jnp.asarray(rng.standard_normal((200, 300)), jnp.float32),
        "nested": {"a": {"b": jnp.zeros((2, 2), jnp.float32)},
                   "pair": (jnp.ones(3, jnp.bfloat16),
                            jnp.asarray(rng.standard_normal(2), jnp.float32))},
        "empty": None,
    }


@pytest.fixture(scope="module")
def jax_init():
    """tpusr's GANTrainState in the CLI tests' configuration (x8, 2
    blocks, hr_patch 32, batch 2; bf16 D state), after one step."""
    cfg = jg.GANTrainConfig(**CLI)
    js = jax.jit(lambda k: jg.create_gan_state(k, cfg, LR))(
        jax.random.key(1))
    return cfg, _strong(js)


def test_read_tree_matches_load_checkpoint(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), _mixed_tree())
    _assert_same_tree(read_tree(str(tmp_path / "ck")),
                      load_checkpoint(str(tmp_path / "ck")))


@pytest.fixture(scope="module")
def tpusr_states(jax_init):
    """tpusr's GANTrainState (2 blocks, hr_patch 32) per d_moments: the
    'f32' one has the 'bf16' one's weights, f32 throughout."""
    cfg16, js16 = jax_init
    cfg32 = jg.GANTrainConfig(**CLI, d_moments="f32", d_params="f32")
    js32 = _strong(jg.create_gan_state(
        jax.random.key(0), cfg32, LR, params_G=js16.params_G,
        stats_G=js16.stats_G, params_D=jax.tree.map(
            lambda a: a.astype(jnp.float32), js16.params_D),
        stats_D=js16.stats_D))
    return {"bf16": (cfg16, js16), "f32": (cfg32, js32)}


@pytest.mark.parametrize("dm", ["bf16", "f32"])
def test_gan_state_both_ways(tpusr_states, tmp_path, dm):
    cfg, js = tpusr_states[dm]
    save_checkpoint(str(tmp_path / "tpusr"), js)
    got = read_tree(str(tmp_path / "tpusr"))
    _assert_same_tree(got, load_checkpoint(str(tmp_path / "tpusr")))
    # the port's own state, exported, is tpusr's tree leaf for leaf
    ps = pg.create_gan_state(pg.GANTrainConfig(**CLI, d_moments=dm,
                                               d_params=dm), 1e-4,
                             device="cpu")
    load_train_state(str(tmp_path / "tpusr"), ps)
    _assert_same_tree(export_flax_gan_state(ps), _state_dict_tree(js))
    save_train_state(str(tmp_path / "port"), ps)
    _assert_same_tree(export_flax_gan_state(ps),
                      _state_dict_tree(load_checkpoint(
                          str(tmp_path / "port"), target=js)))
    _assert_same_tree(export_flax_gan_state(ps),
                      load_checkpoint(str(tmp_path / "port")))


def test_write_tree_restored_by_tpusr(tmp_path):
    ref = _mixed_tree()
    tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).view(
        np.int16)).view(torch.bfloat16) if a.dtype == jnp.bfloat16
        else torch.from_numpy(np.asarray(a).copy()), ref)
    write_tree(str(tmp_path / "ck"), tree)
    write_tree(str(tmp_path / "ck"), tree)  # replaces what is there
    assert not os.path.exists(tmp_path / "ck" / "manifest.ocdbt")
    for restored in (load_checkpoint(str(tmp_path / "ck")),
                     load_checkpoint(str(tmp_path / "ck"), target=ref)):
        _assert_same_tree(tree, restored)
    _assert_same_tree(read_tree(str(tmp_path / "ck")),
                      load_checkpoint(str(tmp_path / "ck")))


def test_cast_like_and_misfits(tpusr_states, tmp_path):
    """A d_moments='f32' checkpoint resumes into bf16 storage (cast as
    tpusr casts) and a tree of another shape raises."""
    _, js32 = tpusr_states["f32"]
    cfg16, js16 = tpusr_states["bf16"]
    save_checkpoint(str(tmp_path / "f32"), js32)
    ps = pg.create_gan_state(pg.GANTrainConfig(**CLI), 1e-4, device="cpu")
    load_train_state(str(tmp_path / "f32"), ps)
    want = load_checkpoint(str(tmp_path / "f32"), target=js16)
    _assert_same_tree(export_flax_gan_state(ps), _state_dict_tree(want))
    with pytest.raises(ValueError, match="does not fit"):
        cast_like({"a": torch.ones(2)}, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="does not fit"):
        load_train_state(str(tmp_path / "f32"), pg.create_gan_state(
            pg.GANTrainConfig(**{**CLI, "residual_blocks_count": 3}), 1e-4,
            device="cpu"))


def test_legacy_state_files_still_load(tpusr_states, tmp_path):
    """A state file of the port's earlier torch.save format resumes."""
    _, js = tpusr_states["bf16"]
    cfg = pg.GANTrainConfig(**CLI)
    ps = pg.create_gan_state(cfg, 1e-4, device="cpu")
    load_flax_gan_state(ps, jax.tree.map(np.asarray, js))
    ps.step = 5

    def opt(o):
        count, ms, vs = pg.adam_moments(o)
        return {"count": count, "m": list(ms), "v": list(vs)}

    torch.save({"format": "tpusr_torch GANTrainState",
                "G": ps.G.state_dict(), "D": ps.D.state_dict(),
                "opt_G": opt(ps.opt_G), "opt_D": opt(ps.opt_D), "step": 5},
               str(tmp_path / "old_state"))
    back = load_train_state(str(tmp_path / "old_state"),
                            pg.create_gan_state(cfg, 1e-4, device="cpu"))
    _assert_same_tree(export_flax_gan_state(back), export_flax_gan_state(ps))


# ---------------------------------------------------------------------------
# the committed tpusr-written fixture


def fixture_tree():
    """The leaves of tests/data/orbax_tpusr_small, from its seed; bf16 as
    its uint16 bits. chip_smoke.py keeps a copy of this function."""
    rng = np.random.default_rng(FIXTURE_SEED)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": (rng.standard_normal(40).astype(np.float32).view(
            np.uint32) >> 16).astype(np.uint16),
        "i32": rng.integers(-2**31, 2**31 - 1, (4, 4), dtype=np.int32),
        "step": np.asarray(rng.integers(0, 1000), np.int32),
        "nested": {"ramp": (np.arange(8192) % 61).astype(np.float32),
                   "pair": [rng.standard_normal(4).astype(np.float32),
                            rng.standard_normal((2, 3)).astype(np.float32)]},
        "random": rng.standard_normal(32768).astype(np.float32),
    }


def _jax_fixture():
    tree = fixture_tree()
    tree["bf16"] = tree["bf16"].view(jnp.bfloat16)
    tree["nested"]["pair"] = tuple(tree["nested"]["pair"])
    return jax.tree.map(jnp.asarray, tree)


def write_fixture(path=FIXTURE):
    """Write the fixture with tpusr's save_checkpoint (run once, from the
    repo's root: python -m tests.test_torch_orbax)."""
    save_checkpoint(path, _jax_fixture())


def test_committed_fixture_holds_its_seed():
    want = _jax_fixture()
    _assert_same_tree(read_tree(FIXTURE), load_checkpoint(FIXTURE))
    _assert_same_tree(read_tree(FIXTURE), want)
    meta = json.load(open(os.path.join(FIXTURE, "_METADATA")))
    assert meta["use_ocdbt"] and not meta["use_zarr3"]
    store = OcdbtStore(FIXTURE)
    raw = store.get("random/.zarray")
    assert json.loads(raw)["compressor"]["id"] == "zstd"
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < 256 << 10


def test_not_a_checkpoint_and_zarr3_raise(tmp_path):
    (tmp_path / "plain").mkdir()
    with pytest.raises(ValueError, match="no _METADATA"):
        read_tree(str(tmp_path / "plain"))
    shutil.copytree(FIXTURE, tmp_path / "z3")
    meta = json.load(open(tmp_path / "z3" / "_METADATA"))
    json.dump({**meta, "use_zarr3": True}, open(tmp_path / "z3" /
                                                "_METADATA", "w"))
    with pytest.raises(ValueError, match="zarr3"):
        read_tree(str(tmp_path / "z3"))


# ---------------------------------------------------------------------------
# the CLIs, both ways


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("div2k")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("valid", 1)):
        hr_dir, lr_dir = root / f"DIV2K_{split}_HR", \
            root / f"DIV2K_{split}_LR_x8"
        hr_dir.mkdir()
        lr_dir.mkdir()
        for i in range(1, n + 1):
            hr = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
            Image.fromarray(hr).save(hr_dir / f"{i:04d}.png")
            Image.fromarray(hr).resize((32, 32), Image.BICUBIC).save(
                lr_dir / f"{i:04d}x8.png")
    return str(root)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((2, 4, 4, 3)).astype(np.float32),
            rng.random((2, 32, 32, 3)).astype(np.float32) * 2 - 1)


@pytest.fixture(scope="module")
def jax_step():
    cfg = jg.GANTrainConfig(**CLI)
    return cfg, jax.jit(lambda s, lo, hi: jg._train_step_core(
        s, lo, hi, cfg, LR, JL.mse))


@pytest.fixture(scope="module")
def tpusr_run(tmp_path_factory, jax_init, jax_step):
    """A tpusr run directory as its train CLI writes it (pre_trained_state,
    the .pth pair, ckpt_epoch1), from one tpusr step, by tpusr's own
    writers."""
    cfg, step = jax_step
    js = _strong(step(jax_init[1], *map(jnp.asarray, _batch(7)))[0])
    out = str(tmp_path_factory.mktemp("tpusr_run"))
    jax_train_cli.save_phase_models(js, "pre_trained", out, cfg)
    save_checkpoint(os.path.join(out, "ckpt_epoch1"), js)
    return out, js


def _one_step_each(ps, js, step, seed):
    """One step of each package from the same state, held to
    tests/test_torch_gan_train.py's tolerances."""
    start = _port_flat(ps)[0]
    count = pg.adam_moments(ps.opt_D)[0]
    lo, hi = _batch(seed)
    js, jlog = step(js, jnp.asarray(lo), jnp.asarray(hi))
    ps, plog = pg.gan_train_step(ps, torch.from_numpy(lo),
                                 torch.from_numpy(hi), pg.GANTrainConfig(
                                     **CLI, g_fuse="eval"))
    for k in ("loss_D", "loss_G"):
        np.testing.assert_allclose(float(plog[k]), float(jlog[k]), rtol=1e-4)
    _compare(ps, _strong(js), start, count + 1)


def _port_cli(data, out, *extra):
    os.makedirs(out, exist_ok=True)
    return train_gan.run(["--data_dir", data, "--out_dir", str(out),
                          "--train_log_freq", "1", "--device", "cpu",
                          *TINY, *extra])


def test_port_resumes_a_tpusr_run(data, tmp_path, tpusr_run, jax_step,
                                  capsys):
    """--resume a tpusr ckpt_epoch1 and --pre_trained_models_path a tpusr
    run directory, in one run of the port's CLI (as in tpusr's, the
    pre-trained nets then start the fine-tune phase with fresh Adam)."""
    out, js = tpusr_run
    ckpt = os.path.join(out, "ckpt_epoch1")
    fine = _port_cli(data, tmp_path / "a", "--resume", ckpt,
                     "--pre_trained_models_path", out,
                     "--fine_tune_epochs", "1")
    assert f"Resumed from {ckpt} at step 1" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(fine, "pre_trained_state"))
    assert os.path.isfile(os.path.join(fine, "fine_tuned_state", "_METADATA"))
    pcfg = pg.GANTrainConfig(**CLI)
    pre = train_gan.load_pretrained(out, pg.create_gan_state(
        pcfg, LR, device="cpu"), pcfg)
    _assert_same_tree(export_flax_gan_state(pre)["params_G"], js.params_G)
    ps = load_train_state(ckpt, pg.create_gan_state(pcfg, LR, device="cpu"))
    assert ps.step == 1
    _one_step_each(ps, js, jax_step[1], seed=8)


def test_tpusr_resumes_a_port_run(data, tmp_path, jax_init, jax_step,
                                  capsys, monkeypatch):
    """tpusr's train CLI takes a port run's ckpt_epoch1 (--resume) and its
    pre_trained_state (--pre_trained_models_path), in one run. The CLI
    draws its initial state eagerly (flax's init op by op: 17 s on a CPU),
    and --resume replaces all of it: the test hands it the same
    configuration's state, drawn under one jit by a fixture."""
    cfg, template = jax_init

    def create_gan_state(key, config, learning_rate, **given):
        if given:
            return jg.create_gan_state(key, config, learning_rate, **given)
        assert (config.d_moments, config.d_params, config.hr_patch) == (
            cfg.d_moments, cfg.d_params, cfg.hr_patch)
        return template

    monkeypatch.setattr(jax_train_cli, "create_gan_state", create_gan_state)
    run = _port_cli(data, tmp_path / "port", "--pre_train_epochs", "1",
                    "--fine_tune_epochs", "0", "--checkpoint_every", "1")
    ckpt = os.path.join(run, "ckpt_epoch1")
    assert os.path.isfile(os.path.join(ckpt, "_METADATA"))
    os.makedirs(tmp_path / "jax")
    capsys.readouterr()
    jout = jax_train_cli.run([
        "--data_dir", data, "--out_dir", str(tmp_path / "jax"),
        "--fine_tune_epochs", "0", *TINY, "--resume", ckpt,
        "--pre_trained_models_path", run])
    assert f"Resumed from {ckpt} at step 2" in capsys.readouterr().out
    assert os.path.isdir(os.path.join(jout, "fine_tuned_state"))
    js = _strong(load_checkpoint(ckpt, target=template))
    ps = load_train_state(ckpt, pg.create_gan_state(pg.GANTrainConfig(**CLI),
                                                    LR, device="cpu"))
    assert ps.step == int(js.step) == 2
    _one_step_each(ps, js, jax_step[1], seed=9)


def test_eval_from_a_tpusr_orbax_directory(data, tmp_path, tpusr_run):
    out, _ = tpusr_run
    state_dir = os.path.join(out, "pre_trained_state")
    args = ["--data_dir", data, "--residual_blocks", "2",
            "--save_images", "True"]

    def run(fn, name, model, *extra):
        (tmp_path / name).mkdir()
        metrics = fn([*args, "--out_dir", str(tmp_path / name),
                      "--model_path", model, *extra])
        (stamp,) = os.listdir(tmp_path / name / "out" / "GANx8")
        img = np.asarray(Image.open(tmp_path / name / "out" / "GANx8" /
                                    stamp / "images" / "0001.png"))
        return metrics, img

    want, _ = run(jax_eval_cli.run, "jax", state_dir)
    got, img = run(eval_gan.run, "orbax", state_dir, "--device", "cpu")
    _, img_pth = run(eval_gan.run, "pth", os.path.join(
        out, "pre_trained_srgan_G.pth"), "--device", "cpu")
    for k in ("avg_psnr", "avg_ssim"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) < 1e-4, k
    np.testing.assert_array_equal(img, img_pth)
    g, _ = eval_gan.load_generator(state_dir, pg.GANTrainConfig(
        residual_blocks_count=2), "cpu")
    g_pth, _ = eval_gan.load_generator(os.path.join(
        out, "pre_trained_srgan_G.pth"), pg.GANTrainConfig(
        residual_blocks_count=2), "cpu")
    for k, v in g_pth.state_dict().items():
        assert torch.equal(g.state_dict()[k], v), k


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_fixture()
